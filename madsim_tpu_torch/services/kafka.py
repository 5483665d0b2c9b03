"""Kafka-style producer/consumer/admin over an in-process SimBroker.

Parity with the reference's madsim-rdkafka (madsim-rdkafka/src/sim/):
  * ``SimBroker`` served on a simulated node; request surface: produce /
    fetch / metadata / watermarks / offsets-for-times / create-topics
    (sim_broker.rs:14-76)
  * topics are lists of partition logs; **produce assigns partitions
    round-robin and ignores the record's requested partition** — a
    deliberate quirk of the reference broker preserved for parity
    (broker.rs:81-111)
  * fetch honors max_bytes and the high watermark (broker.rs:114-156)
  * ``BaseProducer`` buffers up to ``queue.buffering.max.messages``
    records (default 10) then errors QueueFull; ``flush`` drains
    (producer.rs:173-224); transactions buffer until commit
    (producer.rs:237+)
  * ``BaseConsumer`` assign/subscribe with ``auto.offset.reset``, cached
    fetch via poll (consumer.rs:49-207); ``StreamConsumer`` wraps it in
    an async stream (consumer.rs:209-240)
  * ``AdminClient.create_topics`` (admin.rs:80)
  * ``ClientConfig`` string map -> typed client construction
    (config.rs:30-69)
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

from ..net.addr import AddrLike, parse_addr
from ._dual import bind_endpoint, make_notify, now_ns, sleep
from ._transport import RequestClient, serve_requests

__all__ = [
    "KafkaError",
    "SimBroker",
    "ClientConfig",
    "BaseRecord",
    "FutureRecord",
    "Message",
    "BaseProducer",
    "FutureProducer",
    "BaseConsumer",
    "StreamConsumer",
    "AdminClient",
    "NewTopic",
    "TopicPartitionList",
    "Offset",
]

_DEFAULT_QUEUE_MAX = 10  # producer.rs:173-190


class KafkaError(Exception):
    def __init__(self, kind: str, message: str = ""):
        super().__init__(f"{kind}: {message}")
        self.kind = kind
        self.message = message

    def __reduce__(self):
        # preserve (kind, message) across pickling — the std backend
        # ships exceptions over real sockets and group-protocol clients
        # dispatch on .kind (RebalanceInProgress etc.)
        return (KafkaError, (self.kind, self.message))


class BaseRecord:
    """A record to produce. ``partition`` is carried but the broker
    round-robins regardless (broker.rs:81-111)."""

    def __init__(self, topic: str, partition: Optional[int] = None,
                 key: Optional[bytes] = None, payload: Optional[bytes] = None):
        self.topic = topic
        self.partition = partition
        self.key = key
        self.payload = payload

    @classmethod
    def to(cls, topic: str) -> "BaseRecord":
        return cls(topic)

    def set_partition(self, p: int) -> "BaseRecord":
        self.partition = p
        return self

    def set_key(self, k) -> "BaseRecord":
        self.key = k if isinstance(k, bytes) else str(k).encode()
        return self

    def set_payload(self, p) -> "BaseRecord":
        self.payload = p if isinstance(p, bytes) else str(p).encode()
        return self


FutureRecord = BaseRecord


class Message:
    """A consumed record (message.rs)."""

    __slots__ = ("topic", "partition", "offset", "key", "payload", "timestamp")

    def __init__(self, topic, partition, offset, key, payload, timestamp):
        self.topic = topic
        self.partition = partition
        self.offset = offset
        self.key = key
        self.payload = payload
        self.timestamp = timestamp

    def __repr__(self):
        return f"Message({self.topic}[{self.partition}]@{self.offset})"


class Offset:
    BEGINNING = "beginning"
    END = "end"

    def __init__(self, kind: str, offset: int = 0):
        self.kind = kind
        self.offset = offset

    @classmethod
    def at(cls, offset: int) -> "Offset":
        return cls("offset", offset)


class TopicPartitionList:
    def __init__(self) -> None:
        self.items: list[tuple[str, int, Optional[Offset]]] = []

    def add_partition(self, topic: str, partition: int) -> None:
        self.items.append((topic, partition, None))

    def add_partition_offset(self, topic: str, partition: int, offset: Offset) -> None:
        self.items.append((topic, partition, offset))


class NewTopic:
    def __init__(self, name: str, num_partitions: int = 1):
        self.name = name
        self.num_partitions = num_partitions


# ---------------------------------------------------------------------------
# broker
# ---------------------------------------------------------------------------


class _Group:
    """Consumer-group coordinator state (a capability the reference's sim
    lacks: madsim-rdkafka/src/sim/consumer.rs:110-122 is assign-only)."""

    __slots__ = ("generation", "members", "subs", "assignments", "committed",
                 "member_seq")

    def __init__(self) -> None:
        self.generation = 0
        self.members: dict[str, tuple[int, int]] = {}  # id -> (last_hb_ms, session_ms)
        self.subs: dict[str, tuple] = {}  # id -> subscribed topics
        self.assignments: dict[str, list] = {}  # id -> [(topic, partition)]
        self.committed: dict[tuple[str, int], int] = {}
        self.member_seq = 0


class SimBroker:
    """In-process single broker served over the simulated network:

        await kafka.SimBroker().serve("0.0.0.0:9092")
    """

    local_addr = None  # set once serving (bind port 0, read it here)

    def __init__(self) -> None:
        # topic -> list of partition logs; each log is a list of Message
        self.topics: dict[str, list[list[Message]]] = {}
        self._rr: dict[str, int] = {}  # round-robin cursor per topic
        self._data_notify = make_notify()
        self._groups: dict[str, _Group] = {}

    async def serve(self, addr: AddrLike) -> None:
        await serve_requests(
            addr, self._dispatch, KafkaError, name="kafka-request",
            on_bound=lambda a: setattr(self, "local_addr", a),
        )

    async def _dispatch(self, op: str, kw: dict) -> Any:
        if op == "create_topics":
            created = []
            for name, parts in kw["topics"]:
                if name in self.topics:
                    raise KafkaError("TopicAlreadyExists", name)
                self.topics[name] = [[] for _ in range(parts)]
                self._rr[name] = 0
                created.append(name)
            # groups already subscribed to a just-created topic pick up
            # its partitions via a rebalance (the metadata-refresh path
            # of real brokers); without this an early subscriber would
            # starve forever
            for g in self._groups.values():
                if any(
                    t in sub for t in created for sub in g.subs.values()
                ):
                    self._rebalance(g)
            return created
        if op == "produce":
            return self._produce(kw["records"])
        if op == "fetch":
            return self._fetch(kw["topic"], kw["partition"], kw["offset"],
                               kw["max_bytes"])
        if op == "metadata":
            topic = kw.get("topic")
            if topic is not None:
                if topic not in self.topics:
                    raise KafkaError("UnknownTopic", topic)
                return {topic: len(self.topics[topic])}
            return {t: len(ps) for t, ps in self.topics.items()}
        if op == "watermarks":
            log = self._log(kw["topic"], kw["partition"])
            return (0, len(log))
        if op == "offsets_for_times":
            # first offset with timestamp >= target (broker.rs:182-199)
            out = []
            for topic, partition, ts_ms in kw["items"]:
                log = self._log(topic, partition)
                off = next(
                    (m.offset for m in log if m.timestamp >= ts_ms), len(log)
                )
                out.append((topic, partition, off))
            return out
        if op == "join_group":
            return self._join_group(
                kw["group"], kw.get("member_id"), kw["topics"], kw["session_ms"]
            )
        if op == "sync_group":
            g = self._group(kw["group"])
            self._expire(g)
            mid = kw["member_id"]
            if mid not in g.members:
                raise KafkaError("UnknownMemberId", mid)
            if kw["generation"] != g.generation:
                raise KafkaError("RebalanceInProgress", kw["group"])
            return g.assignments.get(mid, [])
        if op == "heartbeat":
            g = self._group(kw["group"])
            mid = kw["member_id"]
            self._expire(g)
            if mid not in g.members:
                raise KafkaError("UnknownMemberId", mid)
            if kw["generation"] != g.generation:
                raise KafkaError("RebalanceInProgress", kw["group"])
            _hb, session = g.members[mid]
            g.members[mid] = (now_ns() // 1_000_000, session)
            return True
        if op == "leave_group":
            g = self._group(kw["group"])
            if kw["member_id"] in g.members:
                del g.members[kw["member_id"]]
                g.subs.pop(kw["member_id"], None)
                self._rebalance(g)
            return True
        if op == "commit_offsets":
            # fenced: a zombie (expired or stale-generation) member must
            # not overwrite the new owner's offsets
            g = self._group(kw["group"])
            self._expire(g)
            mid = kw["member_id"]
            if mid not in g.members:
                raise KafkaError("UnknownMemberId", mid)
            if kw["generation"] != g.generation:
                raise KafkaError("IllegalGeneration", kw["group"])
            for topic, partition, off in kw["items"]:
                g.committed[(topic, partition)] = off
            return True
        if op == "fetch_offsets":
            g = self._group(kw["group"])
            return [
                (t, p, g.committed.get((t, p), -1)) for t, p in kw["items"]
            ]
        raise KafkaError("InvalidOp", op)

    # ---- consumer-group coordination ----------------------------------
    def _group(self, group_id: str) -> _Group:
        if group_id not in self._groups:
            self._groups[group_id] = _Group()
        return self._groups[group_id]

    def _expire(self, g: _Group) -> None:
        """Drop members whose session timed out; triggers a rebalance.
        Lazy (checked on every group op) — deterministic under the
        simulated clock."""
        now_ms = now_ns() // 1_000_000
        dead = [
            mid for mid, (hb, session) in g.members.items()
            if now_ms - hb > session
        ]
        for mid in dead:
            del g.members[mid]
            g.subs.pop(mid, None)
        if dead:
            self._rebalance(g)

    def _rebalance(self, g: _Group) -> None:
        """Round-robin each topic's partitions over the members
        subscribed to THAT topic; bumps the generation so stale members
        get RebalanceInProgress on their next heartbeat/sync."""
        g.generation += 1
        g.assignments = {m: [] for m in g.members}
        for topic in sorted({t for sub in g.subs.values() for t in sub}):
            if topic not in self.topics:
                continue
            members_t = sorted(m for m, sub in g.subs.items() if topic in sub)
            if not members_t:
                continue
            for p in range(len(self.topics[topic])):
                g.assignments[members_t[p % len(members_t)]].append((topic, p))

    def _join_group(self, group_id, member_id, topics, session_ms):
        g = self._group(group_id)
        self._expire(g)
        known = member_id in g.members if member_id else False
        rejoin_same = known and g.subs.get(member_id) == tuple(topics)
        if not member_id:
            g.member_seq += 1
            member_id = f"member-{g.member_seq}"
        g.members[member_id] = (now_ns() // 1_000_000, session_ms)
        g.subs[member_id] = tuple(topics)
        # only a membership/subscription CHANGE bumps the generation —
        # a known member re-entering the handshake (its reaction to a
        # rebalance) must converge on the current generation, otherwise
        # every rejoin would invalidate every other member forever
        if not rejoin_same:
            self._rebalance(g)
        return (member_id, g.generation)

    def _log(self, topic: str, partition: int) -> list[Message]:
        if topic not in self.topics:
            raise KafkaError("UnknownTopic", topic)
        parts = self.topics[topic]
        if not 0 <= partition < len(parts):
            raise KafkaError("UnknownPartition", f"{topic}[{partition}]")
        return parts[partition]

    def _produce(self, records: list) -> list:
        acks = []
        for rec in records:
            topic, _req_partition, key, payload, ts_ms = rec
            if topic not in self.topics:
                raise KafkaError("UnknownTopic", topic)
            parts = self.topics[topic]
            # round-robin placement, requested partition ignored
            # (broker.rs:81-111)
            p = self._rr[topic] % len(parts)
            self._rr[topic] += 1
            log = parts[p]
            msg = Message(topic, p, len(log), key, payload, ts_ms)
            log.append(msg)
            acks.append((topic, p, msg.offset))
        if acks:
            self._data_notify.notify_waiters()
        return acks

    def _fetch(self, topic: str, partition: int, offset: int, max_bytes: int):
        log = self._log(topic, partition)
        out = []
        size = 0
        for m in log[max(offset, 0):]:
            sz = len(m.payload or b"") + len(m.key or b"")
            if out and size + sz > max_bytes:
                break
            out.append((m.topic, m.partition, m.offset, m.key, m.payload,
                        m.timestamp))
            size += sz
        return {"messages": out, "high_watermark": len(log)}


# ---------------------------------------------------------------------------
# clients
# ---------------------------------------------------------------------------


class _Raw(RequestClient):
    def __init__(self, ep, dst):
        super().__init__(
            ep, dst, lambda m: KafkaError("BrokerTransportFailure", m)
        )


class ClientConfig:
    """String-keyed config map -> typed clients (config.rs:30-69)."""

    def __init__(self) -> None:
        self._map: dict[str, str] = {}

    def set(self, key: str, value) -> "ClientConfig":
        self._map[key] = str(value)
        return self

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        return self._map.get(key, default)

    async def create(self, cls: type) -> Any:
        """``await config.create(BaseProducer)``"""
        servers = self._map.get("bootstrap.servers")
        if not servers:
            raise KafkaError("ClientConfig", "bootstrap.servers not set")
        dst = parse_addr(servers.split(",")[0])
        ep = await bind_endpoint("0.0.0.0:0")
        return cls(_Raw(ep, dst), self)


class BaseProducer:
    """Buffering producer (producer.rs:173-224)."""

    async def close(self) -> None:
        await self._raw.close()

    def __init__(self, raw: _Raw, config: ClientConfig):
        self._raw = raw
        self._config = config
        self._queue_max = int(
            config.get("queue.buffering.max.messages", str(_DEFAULT_QUEUE_MAX))
        )
        self._buffer: list = []
        self._in_txn = False
        self._txn_buffer: list = []

    def send(self, record: BaseRecord) -> None:
        """Buffer one record; raises QueueFull past the limit."""
        buf = self._txn_buffer if self._in_txn else self._buffer
        if len(buf) >= self._queue_max and not self._in_txn:
            raise KafkaError("QueueFull", f"more than {self._queue_max} queued")
        buf.append(
            (record.topic, record.partition, record.key, record.payload,
             now_ns() // 1_000_000)
        )

    async def flush(self) -> list:
        """Produce everything buffered (flush_internal, producer.rs:214-224).
        On transport failure the records stay buffered so a retrying
        caller does not silently lose them."""
        if not self._buffer:
            return []
        records, self._buffer = self._buffer, []
        try:
            return await self._raw.call("produce", records=records)
        except KafkaError:
            self._buffer = records + self._buffer
            raise

    # ---- transactions: buffer-until-commit (producer.rs:237+) ----------
    async def init_transactions(self) -> None:
        self._txn_buffer = []

    def begin_transaction(self) -> None:
        if self._in_txn:
            raise KafkaError("InvalidTxnState", "transaction already begun")
        self._in_txn = True

    async def commit_transaction(self) -> list:
        if not self._in_txn:
            raise KafkaError("InvalidTxnState", "no transaction begun")
        self._in_txn = False
        records, self._txn_buffer = self._txn_buffer, []
        if not records:
            return []
        try:
            return await self._raw.call("produce", records=records)
        except KafkaError:
            # commit failed in transit: keep the records so the caller
            # can retry the commit
            self._in_txn = True
            self._txn_buffer = records
            raise

    def abort_transaction(self) -> None:
        if not self._in_txn:
            raise KafkaError("InvalidTxnState", "no transaction begun")
        self._in_txn = False
        self._txn_buffer = []


class FutureProducer:
    """Awaitable per-record producer: returns (partition, offset)."""

    async def close(self) -> None:
        await self._raw.close()

    def __init__(self, raw: _Raw, config: ClientConfig):
        self._raw = raw

    async def send(self, record: BaseRecord, timeout: Optional[float] = None):
        acks = await self._raw.call(
            "produce",
            records=[(record.topic, record.partition, record.key, record.payload,
                      now_ns() // 1_000_000)],
        )
        _topic, partition, offset = acks[0]
        return partition, offset


class BaseConsumer:
    """Pull consumer with assign/subscribe + cached fetch
    (consumer.rs:49-207), plus ``group.id`` consumer groups."""

    async def close(self) -> None:
        if self._group and self._member_id:
            try:
                await self._raw.call(
                    "leave_group", group=self._group, member_id=self._member_id
                )
            except KafkaError:
                pass  # broker gone: the session timeout reaps us
        await self._raw.close()

    def __init__(self, raw: _Raw, config: ClientConfig):
        self._raw = raw
        self._config = config
        self._reset = config.get("auto.offset.reset", "latest")
        self._max_bytes = int(config.get("fetch.message.max.bytes", "1048576"))
        # (topic, partition) -> next offset
        self._positions: dict[tuple[str, int], int] = {}
        self._cache: list[Message] = []
        # consumer-group state ("group.id" set => subscribe coordinates
        # through the broker's group protocol; beats the assign-only
        # reference sim, consumer.rs:110-122)
        self._group = config.get("group.id")
        self._session_ms = int(config.get("session.timeout.ms", "10000"))
        self._hb_interval_ms = int(config.get("heartbeat.interval.ms", "3000"))
        self._auto_commit = (
            config.get("enable.auto.commit", "true").lower() == "true"
        )
        self._commit_interval_ms = int(
            config.get("auto.commit.interval.ms", "5000")
        )
        self._member_id: Optional[str] = None
        self._generation = 0
        self._sub_topics: tuple = ()
        self._last_hb_ms = 0
        self._last_commit_ms = 0
        # (topic, partition) -> next offset the APP has consumed through
        # poll(); commits use this, not the fetch position, so messages
        # cached but never delivered are re-read after a crash
        # (at-least-once, the librdkafka stored-offset behavior)
        self._processed: dict[tuple[str, int], int] = {}

    async def subscribe(self, topics: Iterable[str]) -> None:
        """Without ``group.id``: consume every partition (the reference
        sim's behavior). With ``group.id``: join the consumer group and
        consume only the partitions the coordinator assigns."""
        topics = tuple(topics)
        if self._group:
            self._sub_topics = topics
            await self._join_group()
            return
        for topic in topics:
            meta = await self._raw.call("metadata", topic=topic)
            for p in range(meta[topic]):
                await self._position_for(topic, p)

    # ---- group membership ---------------------------------------------
    async def _join_group(self) -> None:
        while True:
            self._member_id, self._generation = await self._raw.call(
                "join_group", group=self._group, member_id=self._member_id,
                topics=list(self._sub_topics), session_ms=self._session_ms,
            )
            try:
                assignment = await self._raw.call(
                    "sync_group", group=self._group, member_id=self._member_id,
                    generation=self._generation,
                )
                break
            except KafkaError as e:
                # another member joined/left between our join and sync:
                # re-enter the handshake at the new generation
                if e.kind not in ("RebalanceInProgress", "UnknownMemberId"):
                    raise
                await sleep(0.05)
        self._cache.clear()
        self._positions.clear()
        committed = await self._raw.call(
            "fetch_offsets", group=self._group,
            items=[(t, p) for t, p in assignment],
        )
        for topic, partition, off in committed:
            if off >= 0:
                self._positions[(topic, partition)] = off
            else:
                await self._position_for(topic, partition)
        self._processed = dict(self._positions)
        self._last_hb_ms = now_ns() // 1_000_000

    def assignment(self) -> list:
        """The partitions this consumer currently owns."""
        return sorted(self._positions)

    async def commit(self) -> None:
        """Commit processed positions to the group coordinator. Fenced
        by (member_id, generation): a commit from a member the broker
        has expired or rebalanced past raises UnknownMemberId /
        IllegalGeneration instead of clobbering the new owner."""
        if not self._group:
            raise KafkaError("InvalidConfig", "commit requires group.id")
        await self._raw.call(
            "commit_offsets", group=self._group,
            member_id=self._member_id, generation=self._generation,
            items=[(t, p, off) for (t, p), off in self._processed.items()],
        )
        self._last_commit_ms = now_ns() // 1_000_000

    async def _group_tick(self) -> None:
        """Heartbeat + auto-commit pacing, driven by poll() the way
        librdkafka drives its coordinator from the poll loop. A
        RebalanceInProgress / UnknownMemberId answer re-joins, which
        picks up the post-rebalance assignment."""
        now_ms = now_ns() // 1_000_000
        stale = ("RebalanceInProgress", "UnknownMemberId", "IllegalGeneration")
        if self._auto_commit and (
            now_ms - self._last_commit_ms >= self._commit_interval_ms
        ):
            try:
                await self.commit()
            except KafkaError as e:
                # fenced: we are a zombie — rejoin rather than clobber
                # the new owner's offsets (uncommitted progress is
                # re-delivered: at-least-once)
                if e.kind not in stale:
                    raise
                await self._join_group()
                return
        if now_ms - self._last_hb_ms >= self._hb_interval_ms:
            try:
                await self._raw.call(
                    "heartbeat", group=self._group,
                    member_id=self._member_id, generation=self._generation,
                )
                self._last_hb_ms = now_ms
            except KafkaError as e:
                if e.kind in stale:
                    await self._join_group()
                else:
                    raise

    async def assign(self, tpl: TopicPartitionList) -> None:
        for topic, partition, offset in tpl.items:
            if offset is None:
                await self._position_for(topic, partition)
            elif offset.kind == "beginning":
                self._positions[(topic, partition)] = 0
            elif offset.kind == "end":
                lo, hi = await self._raw.call(
                    "watermarks", topic=topic, partition=partition
                )
                self._positions[(topic, partition)] = hi
            else:
                self._positions[(topic, partition)] = offset.offset

    async def _position_for(self, topic: str, partition: int) -> None:
        if self._reset == "earliest":
            self._positions[(topic, partition)] = 0
        else:
            _lo, hi = await self._raw.call(
                "watermarks", topic=topic, partition=partition
            )
            self._positions[(topic, partition)] = hi

    async def poll(self) -> Optional[Message]:
        """Next message from cache, fetching when empty
        (poll_internal, consumer.rs:179-207); None when nothing new."""
        if self._group and self._member_id:
            await self._group_tick()
        if self._cache:
            m = self._cache.pop(0)
            self._processed[(m.topic, m.partition)] = m.offset + 1
            return m
        for (topic, partition), offset in sorted(self._positions.items()):
            r = await self._raw.call(
                "fetch", topic=topic, partition=partition, offset=offset,
                max_bytes=self._max_bytes,
            )
            msgs = [Message(*m) for m in r["messages"]]
            if msgs:
                self._positions[(topic, partition)] = msgs[-1].offset + 1
                self._cache.extend(msgs)
                m = self._cache.pop(0)
                self._processed[(m.topic, m.partition)] = m.offset + 1
                return m
        return None

    async def offsets_for_times(self, items) -> list:
        return await self._raw.call("offsets_for_times", items=list(items))

    async def fetch_watermarks(self, topic: str, partition: int):
        return await self._raw.call("watermarks", topic=topic, partition=partition)


class StreamConsumer(BaseConsumer):
    """Async-stream consumer: ``async for`` / awaited recv with a poll
    loop (consumer.rs:209-240)."""

    async def recv(self) -> Message:
        while True:
            msg = await self.poll()
            if msg is not None:
                return msg
            await sleep(0.05)

    def __aiter__(self):
        return self

    async def __anext__(self) -> Message:
        return await self.recv()


class AdminClient:
    async def close(self) -> None:
        await self._raw.close()

    def __init__(self, raw: _Raw, config: ClientConfig):
        self._raw = raw

    async def create_topics(self, topics: Iterable[NewTopic]) -> list:
        return await self._raw.call(
            "create_topics", topics=[(t.name, t.num_partitions) for t in topics]
        )
