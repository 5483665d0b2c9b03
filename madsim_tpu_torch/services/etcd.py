"""etcd v3 simulator: KV / Txn / Lease / Election over the simulated net.

Parity with the reference's madsim-etcd-client (madsim-etcd-client/src/):
  * ``SimServer`` builder serving an in-process single-node etcd state
    machine on a simulated address (server.rs:8-70)
  * the 14-op request surface: put/get(range)/delete/txn, lease
    grant/revoke/keep-alive/ttl/leases, campaign/proclaim/leader/resign
    (server.rs:73-127, service.rs:136-442)
  * revision bookkeeping: global revision bumps on every mutation;
    per-key create_revision / mod_revision / version (service.rs:127-134)
  * leases tick down once per simulated second and expiry deletes
    attached keys (service.rs:20-26, 353-370)
  * election campaign parks waiters in FIFO order and wakes the next
    on resign/expiry (poll_campaign, service.rs:372-409); ``observe``
    streams leader changes — implemented here although the reference
    server answers it Unimplemented (server.rs:60)
  * fault injection: with probability ``timeout_rate`` a request stalls
    5-15 simulated seconds and fails UNAVAILABLE (service.rs:113-124)

Client classes mirror the etcd-client API shape (KvClient, LeaseClient,
ElectionClient); every op is one connection round-trip like the
reference's kv.rs:25-100. Values are bytes; keys are bytes.

Dual-mode (the reference's cfg-switch contract, lib.rs:1-8): inside a
simulation the server and clients ride the simulated network; outside,
the same classes run over real localhost TCP via madsim_tpu_torch.std.net.
"""

from __future__ import annotations

from typing import Any, Optional

from ..net.addr import AddrLike, parse_addr
from ._dual import bind_endpoint, make_notify, rng, sleep, spawn
from ._transport import RequestClient, ResponseStream, StreamReply, serve_requests

__all__ = [
    "EtcdError",
    "SimServer",
    "Client",
    "KvClient",
    "LeaseClient",
    "ElectionClient",
    "KeyValue",
    "Compare",
    "Txn",
    "TxnOp",
    "PutOptions",
    "GetOptions",
    "DeleteOptions",
]


class EtcdError(Exception):
    """etcd-compatible error (error.rs:10-40)."""

    def __init__(self, kind: str, message: str = ""):
        super().__init__(f"{kind}: {message}")
        self.kind = kind
        self.message = message


def _to_bytes(x: "bytes | str") -> bytes:
    return x.encode() if isinstance(x, str) else bytes(x)


class KeyValue:
    """A stored key-value with etcd revision metadata."""

    __slots__ = ("key", "value", "create_revision", "mod_revision", "version", "lease")

    def __init__(self, key, value, create_revision, mod_revision, version, lease):
        self.key = key
        self.value = value
        self.create_revision = create_revision
        self.mod_revision = mod_revision
        self.version = version
        self.lease = lease

    def _copy(self) -> "KeyValue":
        return KeyValue(
            self.key, self.value, self.create_revision, self.mod_revision,
            self.version, self.lease,
        )

    def __repr__(self) -> str:
        return f"KeyValue({self.key!r}={self.value!r} @mod {self.mod_revision})"


# ---- options (kv.rs option structs) ---------------------------------------


class PutOptions:
    def __init__(self, lease: int = 0, prev_kv: bool = False):
        self.lease = lease
        self.prev_kv = prev_kv


class GetOptions:
    def __init__(
        self,
        prefix: bool = False,
        range_end: Optional[bytes] = None,
        limit: int = 0,
        count_only: bool = False,
        keys_only: bool = False,
    ):
        self.prefix = prefix
        self.range_end = range_end
        self.limit = limit
        self.count_only = count_only
        self.keys_only = keys_only


class DeleteOptions:
    def __init__(self, prefix: bool = False, range_end: Optional[bytes] = None,
                 prev_kv: bool = False):
        self.prefix = prefix
        self.range_end = range_end
        self.prev_kv = prev_kv


class Compare:
    """Txn guard (kv.rs:247-460). op in {'=', '!=', '>', '<'};
    target in {'value', 'version', 'create', 'mod', 'lease'}."""

    def __init__(self, key, target: str, op: str, operand):
        self.key = _to_bytes(key)
        self.target = target
        self.op = op
        self.operand = operand

    @classmethod
    def value(cls, key, op, v):
        return cls(key, "value", op, _to_bytes(v))

    @classmethod
    def version(cls, key, op, v):
        return cls(key, "version", op, int(v))

    @classmethod
    def create_revision(cls, key, op, v):
        return cls(key, "create", op, int(v))

    @classmethod
    def mod_revision(cls, key, op, v):
        return cls(key, "mod", op, int(v))


class TxnOp:
    def __init__(self, kind: str, *args: Any):
        self.kind = kind
        self.args = args

    @classmethod
    def put(cls, key, value, options: Optional[PutOptions] = None):
        return cls("put", _to_bytes(key), _to_bytes(value), options or PutOptions())

    @classmethod
    def get(cls, key, options: Optional[GetOptions] = None):
        return cls("get", _to_bytes(key), options or GetOptions())

    @classmethod
    def delete(cls, key, options: Optional[DeleteOptions] = None):
        return cls("delete", _to_bytes(key), options or DeleteOptions())


class Txn:
    """compare-and-do transaction (kv.rs Txn builder)."""

    def __init__(self) -> None:
        self._when: list[Compare] = []
        self._then: list[TxnOp] = []
        self._else: list[TxnOp] = []

    def when(self, compares) -> "Txn":
        self._when = list(compares)
        return self

    def and_then(self, ops) -> "Txn":
        self._then = list(ops)
        return self

    def or_else(self, ops) -> "Txn":
        self._else = list(ops)
        return self


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class _ServiceInner:
    """The etcd state machine (service.rs:127-134)."""

    def __init__(self) -> None:
        self.revision = 0
        self.kv: dict[bytes, KeyValue] = {}
        # lease id -> [ttl, remaining_seconds, set(keys)]
        self.leases: dict[int, list] = {}
        # election name -> list of waiting campaigns (FIFO)
        self.waiters: dict[bytes, list] = {}

    # ---- kv ---------------------------------------------------------------
    def _range(self, key: bytes, opt: GetOptions) -> list[KeyValue]:
        if opt.prefix:
            out = [kv for k, kv in sorted(self.kv.items()) if k.startswith(key)]
        elif opt.range_end:
            out = [
                kv for k, kv in sorted(self.kv.items()) if key <= k < opt.range_end
            ]
        else:
            kv = self.kv.get(key)
            out = [kv] if kv is not None else []
        if opt.limit:
            out = out[: opt.limit]
        return out

    def put(self, key: bytes, value: bytes, opt: PutOptions):
        self.revision += 1
        prev = self.kv.get(key)
        if prev is not None:
            nkv = KeyValue(
                key, value, prev.create_revision, self.revision, prev.version + 1,
                opt.lease,
            )
        else:
            nkv = KeyValue(key, value, self.revision, self.revision, 1, opt.lease)
        if opt.lease:
            if opt.lease not in self.leases:
                self.revision -= 1
                raise EtcdError("LeaseError", f"lease {opt.lease} not found")
            self.leases[opt.lease][2].add(key)
        if prev is not None and prev.lease and prev.lease != opt.lease:
            lease = self.leases.get(prev.lease)
            if lease:
                lease[2].discard(key)
        self.kv[key] = nkv
        return {"header_revision": self.revision,
                "prev_kv": prev._copy() if (prev and opt.prev_kv) else None}

    def get(self, key: bytes, opt: GetOptions):
        kvs = self._range(key, opt)
        return {
            "header_revision": self.revision,
            "count": len(kvs),
            "kvs": [] if opt.count_only else [kv._copy() for kv in kvs],
        }

    def delete(self, key: bytes, opt: DeleteOptions):
        kvs = self._range(
            key, GetOptions(prefix=opt.prefix, range_end=opt.range_end)
        )
        if kvs:
            self.revision += 1
        deleted = []
        for kv in kvs:
            del self.kv[kv.key]
            if kv.lease and kv.lease in self.leases:
                self.leases[kv.lease][2].discard(kv.key)
            deleted.append(kv)
        return {
            "header_revision": self.revision,
            "deleted": len(deleted),
            "prev_kvs": deleted if opt.prev_kv else [],
        }

    # ---- txn (service.rs:250-284) ------------------------------------------
    def _check(self, c: Compare) -> bool:
        kv = self.kv.get(c.key)
        if c.target == "value":
            actual = kv.value if kv else None
            if actual is None:
                return False
        elif c.target == "version":
            actual = kv.version if kv else 0
        elif c.target == "create":
            actual = kv.create_revision if kv else 0
        elif c.target == "mod":
            actual = kv.mod_revision if kv else 0
        elif c.target == "lease":
            actual = kv.lease if kv else 0
        else:
            raise EtcdError("InvalidArgs", f"bad compare target {c.target}")
        if c.op == "=":
            return actual == c.operand
        if c.op == "!=":
            return actual != c.operand
        if c.op == ">":
            return actual > c.operand
        if c.op == "<":
            return actual < c.operand
        raise EtcdError("InvalidArgs", f"bad compare op {c.op}")

    def txn(self, t: Txn):
        succeeded = all(self._check(c) for c in t._when)
        ops = t._then if succeeded else t._else
        # validate before applying so a txn is all-or-nothing like real
        # etcd: the only op that can fail is a put with an unknown lease
        for op in ops:
            if op.kind == "put" and op.args[2].lease and (
                op.args[2].lease not in self.leases
            ):
                raise EtcdError("LeaseError", f"lease {op.args[2].lease} not found")
        results = []
        for op in ops:
            if op.kind == "put":
                results.append(("put", self.put(op.args[0], op.args[1], op.args[2])))
            elif op.kind == "get":
                results.append(("get", self.get(op.args[0], op.args[1])))
            elif op.kind == "delete":
                results.append(("delete", self.delete(op.args[0], op.args[1])))
        return {
            "header_revision": self.revision,
            "succeeded": succeeded,
            "responses": results,
        }

    # ---- leases (service.rs:286-370) ----------------------------------------
    def lease_grant(self, ttl: int, lease_id: int, rng) -> dict:
        if lease_id == 0:
            lease_id = rng.randrange(1, 1 << 62)
        if lease_id in self.leases:
            raise EtcdError("LeaseError", f"lease {lease_id} already exists")
        self.leases[lease_id] = [ttl, ttl, set()]
        return {"id": lease_id, "ttl": ttl}

    def lease_revoke(self, lease_id: int) -> dict:
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            raise EtcdError("LeaseError", f"lease {lease_id} not found")
        woken = []
        for key in sorted(lease[2]):
            self.kv.pop(key, None)
            woken.append(key)
        if woken:
            self.revision += 1
        return {"header_revision": self.revision, "expired_keys": woken}

    def lease_keep_alive(self, lease_id: int) -> dict:
        lease = self.leases.get(lease_id)
        if lease is None:
            raise EtcdError("LeaseError", f"lease {lease_id} not found")
        lease[1] = lease[0]
        return {"id": lease_id, "ttl": lease[0]}

    def lease_ttl(self, lease_id: int) -> dict:
        lease = self.leases.get(lease_id)
        if lease is None:
            raise EtcdError("LeaseError", f"lease {lease_id} not found")
        return {"id": lease_id, "granted_ttl": lease[0], "ttl": lease[1],
                "keys": sorted(lease[2])}

    def lease_list(self) -> dict:
        return {"leases": sorted(self.leases)}

    def tick(self) -> list[bytes]:
        """One simulated second: age leases, expire, delete attached keys,
        return expired election leader keys so campaigns re-run
        (service.rs:353-370)."""
        expired = [lid for lid, lease in self.leases.items() if lease[1] <= 1]
        for lease in self.leases.values():
            lease[1] -= 1
        keys = []
        for lid in expired:
            keys += self.lease_revoke(lid)["expired_keys"]
        return keys

    # ---- election (service.rs:372-442) ---------------------------------------
    def leader_kv(self, name: bytes) -> Optional[KeyValue]:
        cands = [kv for k, kv in self.kv.items() if k.startswith(name + b"/")]
        if not cands:
            return None
        return min(cands, key=lambda kv: kv.create_revision)

    def try_campaign(self, name: bytes, value: bytes, lease_id: int):
        """Succeeds iff nobody currently owns the election."""
        if self.leader_kv(name) is not None:
            return None
        key = name + b"/" + hex(lease_id)[2:].encode()
        self.put(key, value, PutOptions(lease=lease_id))
        kv = self.kv[key]
        return {"name": name, "key": key, "rev": kv.create_revision,
                "lease": lease_id}


class SimServer:
    """etcd server builder (server.rs:8-24):

        await etcd.SimServer(timeout_rate=0.1).serve("0.0.0.0:2379")
    """

    local_addr = None  # set once serving (bind port 0, read it here)

    def __init__(self, timeout_rate: float = 0.0):
        self.timeout_rate = timeout_rate
        self._inner = _ServiceInner()
        self._election_notify = make_notify()

    def with_timeout_rate(self, rate: float) -> "SimServer":
        self.timeout_rate = rate
        return self

    async def serve(self, addr: AddrLike) -> None:
        spawn(self._lease_ticker(), name="etcd-lease-ticker")
        await serve_requests(
            addr, self._handle, EtcdError, name="etcd-request",
            on_bound=lambda a: setattr(self, "local_addr", a),
        )

    async def _lease_ticker(self) -> None:
        # 1 s lease tick task (service.rs:20-26)
        while True:
            await sleep(1.0)
            expired = self._inner.tick()
            if expired:
                self._election_notify.notify_waiters()

    async def _handle(self, op: str, kwargs: dict) -> Any:
        # fault injection (service.rs:113-124): stall then Unavailable
        if self.timeout_rate > 0 and rng().random_bool(self.timeout_rate):
            await sleep(rng().randrange(5, 15))
            raise EtcdError("GRpcStatus", "Unavailable")
        return await self._dispatch(op, kwargs)

    async def _dispatch(self, op: str, kw: dict) -> Any:
        inner = self._inner
        if op == "put":
            return inner.put(kw["key"], kw["value"], kw["options"])
        if op == "get":
            return inner.get(kw["key"], kw["options"])
        if op == "delete":
            r = inner.delete(kw["key"], kw["options"])
            if r["deleted"]:
                # a deleted key may have been an election leader key:
                # wake blocked campaigns so they can re-check
                self._election_notify.notify_waiters()
            return r
        if op == "txn":
            r = inner.txn(kw["txn"])
            if any(
                kind == "delete" and res["deleted"]
                for kind, res in r["responses"]
            ):
                self._election_notify.notify_waiters()
            return r
        if op == "lease_grant":
            return inner.lease_grant(kw["ttl"], kw["id"], rng())
        if op == "lease_revoke":
            r = inner.lease_revoke(kw["id"])
            self._election_notify.notify_waiters()
            return r
        if op == "lease_keep_alive":
            return inner.lease_keep_alive(kw["id"])
        if op == "lease_ttl":
            return inner.lease_ttl(kw["id"])
        if op == "lease_list":
            return inner.lease_list()
        if op == "campaign":
            # FIFO wait until the election is free (poll_campaign,
            # service.rs:372-409)
            name, value, lease = kw["name"], kw["value"], kw["lease"]
            while True:
                win = inner.try_campaign(name, value, lease)
                if win is not None:
                    # a new leader exists: observers must hear about it
                    self._election_notify.notify_waiters()
                    return win
                if lease and lease not in inner.leases:
                    raise EtcdError("LeaseError", f"lease {lease} expired")
                await self._election_notify.notified()
        if op == "proclaim":
            key, value = kw["key"], kw["value"]
            kv = inner.kv.get(key)
            if kv is None:
                raise EtcdError("ElectError", "session expired / not leader")
            inner.put(key, value, PutOptions(lease=kv.lease))
            self._election_notify.notify_waiters()
            return {"header_revision": inner.revision}
        if op == "leader":
            kv = inner.leader_kv(kw["name"])
            if kv is None:
                raise EtcdError("ElectError", "no leader")
            return {"kv": kv._copy()}
        if op == "resign":
            key = kw["key"]
            if inner.kv.pop(key, None) is not None:
                inner.revision += 1
                self._election_notify.notify_waiters()
            return {"header_revision": inner.revision}
        if op == "observe":
            # leader-change stream — the reference server left this
            # unimplemented (madsim-etcd-client/src/server.rs:60); real
            # etcd semantics: report the current leader, then every
            # change, with rapid flaps allowed to coalesce
            return StreamReply(self._observe(kw["name"]))
        raise EtcdError("InvalidArgs", f"unknown op {op}")

    async def _observe(self, name: bytes):
        last = None
        while True:
            kv = self._inner.leader_kv(name)
            if kv is not None and (kv.key, kv.mod_revision) != last:
                last = (kv.key, kv.mod_revision)
                yield {"kv": kv._copy()}
                # re-check before parking: a change that landed while the
                # yielded item was in flight must not wait for the next wake
                continue
            await self._election_notify.notified()


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class _Raw(RequestClient):
    """One-connection-per-request client core (kv.rs:25-100 pattern)."""

    def __init__(self, ep, dst):
        super().__init__(
            ep, dst, lambda m: EtcdError("GRpcStatus", f"Unavailable: {m}")
        )


class Client:
    """``await etcd.Client.connect(["10.0.0.1:2379"])`` (sim.rs:33-45:
    takes the first endpoint)."""

    def __init__(self, raw: _Raw):
        self._raw = raw

    @classmethod
    async def connect(cls, endpoints, options: Any = None) -> "Client":
        if isinstance(endpoints, (str, tuple)):
            endpoints = [endpoints]
        dst = parse_addr(endpoints[0])
        ep = await bind_endpoint("0.0.0.0:0")
        return cls(_Raw(ep, dst))

    async def close(self) -> None:
        await self._raw.close()

    def kv_client(self) -> "KvClient":
        return KvClient(self._raw)

    def lease_client(self) -> "LeaseClient":
        return LeaseClient(self._raw)

    def election_client(self) -> "ElectionClient":
        return ElectionClient(self._raw)

    # convenience passthroughs like etcd-client's Client
    async def put(self, key, value, options: Optional[PutOptions] = None):
        return await self.kv_client().put(key, value, options)

    async def get(self, key, options: Optional[GetOptions] = None):
        return await self.kv_client().get(key, options)

    async def delete(self, key, options: Optional[DeleteOptions] = None):
        return await self.kv_client().delete(key, options)

    async def txn(self, txn: Txn):
        return await self.kv_client().txn(txn)


class KvClient:
    def __init__(self, raw: _Raw):
        self._raw = raw

    async def put(self, key, value, options: Optional[PutOptions] = None):
        return await self._raw.call(
            "put", key=_to_bytes(key), value=_to_bytes(value),
            options=options or PutOptions(),
        )

    async def get(self, key, options: Optional[GetOptions] = None):
        return await self._raw.call(
            "get", key=_to_bytes(key), options=options or GetOptions()
        )

    async def delete(self, key, options: Optional[DeleteOptions] = None):
        return await self._raw.call(
            "delete", key=_to_bytes(key), options=options or DeleteOptions()
        )

    async def txn(self, txn: Txn):
        return await self._raw.call("txn", txn=txn)


class LeaseKeeper:
    """Periodic keep-alive helper (lease.rs:170)."""

    def __init__(self, raw: _Raw, lease_id: int):
        self._raw = raw
        self.id = lease_id

    async def keep_alive(self) -> dict:
        return await self._raw.call("lease_keep_alive", id=self.id)


class LeaseClient:
    def __init__(self, raw: _Raw):
        self._raw = raw

    async def grant(self, ttl: int, lease_id: int = 0) -> dict:
        return await self._raw.call("lease_grant", ttl=int(ttl), id=int(lease_id))

    async def revoke(self, lease_id: int) -> dict:
        return await self._raw.call("lease_revoke", id=int(lease_id))

    async def keep_alive(self, lease_id: int) -> LeaseKeeper:
        keeper = LeaseKeeper(self._raw, lease_id)
        await keeper.keep_alive()
        return keeper

    async def time_to_live(self, lease_id: int) -> dict:
        return await self._raw.call("lease_ttl", id=int(lease_id))

    async def leases(self) -> dict:
        return await self._raw.call("lease_list")


class ElectionClient:
    def __init__(self, raw: _Raw):
        self._raw = raw

    async def campaign(self, name, value, lease: int) -> dict:
        """Blocks until this candidate wins ``name`` (FIFO order)."""
        return await self._raw.call(
            "campaign", name=_to_bytes(name), value=_to_bytes(value), lease=int(lease)
        )

    async def proclaim(self, key, value) -> dict:
        return await self._raw.call(
            "proclaim", key=_to_bytes(key), value=_to_bytes(value)
        )

    async def leader(self, name) -> dict:
        return await self._raw.call("leader", name=_to_bytes(name))

    async def resign(self, key) -> dict:
        return await self._raw.call("resign", key=_to_bytes(key))

    async def observe(self, name) -> ResponseStream:
        """Stream of leader changes for ``name``: the current leader
        first, then every handover (campaign win, proclaim, resign,
        lease expiry). Beats the reference — its server answers this
        with Unimplemented (madsim-etcd-client/src/server.rs:60).
        Iterate with ``async for`` or ``await stream.message()``;
        ``stream.close()`` cancels."""
        return await self._raw.call_stream("observe", name=_to_bytes(name))
