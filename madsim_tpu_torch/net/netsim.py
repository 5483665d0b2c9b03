"""NetSim — the network device simulator plugin.

Parity with reference madsim/src/sim/net/mod.rs:
  * ``Simulator`` plugin owning the :class:`Network` graph; per-node state
    created on node creation and wiped on reset (mod.rs:93-117).
  * user-facing chaos API: clog/unclog node and link, stats
    (mod.rs:126-216).
  * datagram send path: random 0-5 us processing delay, send hooks (the
    RPC-drop chaos hook, mod.rs:223-262), route through the network fault
    model, then a latency timer that delivers into the destination socket
    (mod.rs:265-302).
  * reliable ordered "connections": per-direction pipes drained by a pump
    task on the sending node that re-checks link clog state per message
    with 1 ms -> 10 s exponential backoff (mod.rs:329-365), so a partition
    stalls the stream and recovery resumes it in order.
"""

from __future__ import annotations

from collections import deque
from typing import Callable

from ..runtime import context
from ..runtime.future import SimFuture
from ..runtime.plugin import Simulator
from ..runtime.time_ import NANOS_PER_SEC
from .addr import SocketAddr
from .network import Network, Stat

__all__ = ["NetSim", "Pipe", "PipeSender", "PipeReceiver"]

_MAX_PROCESSING_DELAY_NS = 5_000  # 0-5 us (mod.rs:265-270)
_BACKOFF_MIN_NS = 1_000_000  # 1 ms
_BACKOFF_MAX_NS = 10 * NANOS_PER_SEC  # 10 s


class Pipe:
    """One direction of a reliable ordered connection."""

    __slots__ = ("src_node", "dst_node", "queue", "waiters", "closed", "on_close", "group")

    def __init__(self, src_node: int, dst_node: int):
        self.src_node = src_node
        self.dst_node = dst_node
        self.queue: deque = deque()
        self.waiters: deque[SimFuture] = deque()
        self.closed = False
        self.on_close = None  # set by NetSim.register_pipe for dereg
        self.group: tuple = ()  # all pipes of the same connection

    def push(self, item: object) -> None:
        while self.waiters:
            w = self.waiters.popleft()
            if not w.done():
                w.set_result(item)
                return
        self.queue.append(item)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        while self.waiters:
            w = self.waiters.popleft()
            if not w.done():
                w.set_result(None)
        if self.on_close is not None:
            self.on_close(self)
            self.on_close = None

    def pop(self) -> SimFuture:
        fut = SimFuture(name="pipe.pop")
        if self.queue:
            fut.set_result(self.queue.popleft())
        elif self.closed:
            fut.set_result(None)
        else:
            self.waiters.append(fut)
        return fut


class PipeSender:
    """Sending half of a connection (mod.rs:329-340 Sender)."""

    __slots__ = ("_out",)

    def __init__(self, out: Pipe):
        self._out = out

    async def send(self, payload: object) -> None:
        if self._out.closed:
            raise ConnectionResetError("connection closed by peer or node reset")
        self._out.push(payload)

    def is_closed(self) -> bool:
        return self._out.closed

    def shutdown(self) -> None:
        """Close this direction only (half-close): the peer sees EOF after
        in-flight data drains; the reverse direction keeps working."""
        self._out.close()

    def close(self) -> None:
        """Close the whole connection: both directions end, the peer's
        reads EOF, its sends fail, and the pump tasks exit so all pipe
        resources are released."""
        for p in self._out.group or (self._out,):
            p.close()


class PipeReceiver:
    """Receiving half of a connection; ``recv`` returns None on EOF."""

    __slots__ = ("_in",)

    def __init__(self, inp: Pipe):
        self._in = inp

    async def recv(self) -> object | None:
        return await self._in.pop()

    def close(self) -> None:
        """Close the whole connection (see PipeSender.close)."""
        for p in self._in.group or (self._in,):
            p.close()


class NetSim(Simulator):
    """The network simulator plugin (mod.rs:77-117)."""

    def __init__(self, rng, time, config, handle):
        super().__init__(rng, time, config, handle)
        self.network = Network(rng, config.net)
        self._send_hooks: dict[int, Callable] = {}
        self._next_hook_id = 0
        # typed RPC hooks, one per node like the reference's HashMap
        # (mod.rs:82-83): req keyed by SENDING node, consulted at send;
        # rsp keyed by DESTINATION node, consulted at delivery
        self._hooks_req: dict[int, Callable[[object], bool]] = {}
        self._hooks_rsp: dict[int, Callable[[object], bool]] = {}
        # pipes registered per node id — closed when the node resets,
        # deregistered when they close (no growth across connection churn).
        # An insertion-ordered dict, not a set: a reset closes the pipes in
        # registration order, so the wakeups it schedules (and the draws
        # they make) do not follow the objects' addresses.
        self._pipes_by_node: dict[int, dict[Pipe, None]] = {}
        # unix-domain socket namespace: (node_id, path) -> bound socket.
        # Node-local IPC (paths never cross machines), wiped on reset.
        self.unix_binds: dict[tuple[int, str], object] = {}
        # chaos: datagram duplication flag (set_duplicate)
        self._duplicate = False

    # ---- Simulator lifecycle -------------------------------------------
    def create_node(self, node_id: int) -> None:
        info = self.handle.executor.nodes.get(node_id)
        self.network.insert_node(node_id, info.ip if info else None)

    def reset_node(self, node_id: int) -> None:
        self.network.reset_node(node_id)
        for pipe in list(self._pipes_by_node.get(node_id, ())):
            pipe.close()
        self._pipes_by_node.pop(node_id, None)
        for key in [k for k in self.unix_binds if k[0] == node_id]:
            sock = self.unix_binds.pop(key)
            on_reset = getattr(sock, "_on_node_reset", None)
            if on_reset is not None:
                on_reset()

    # ---- stats / chaos (mod.rs:126-216) --------------------------------
    @property
    def stat(self) -> Stat:
        return self.network.stat

    @staticmethod
    def _nid(node) -> int:
        return node if isinstance(node, int) else node.id

    def clog_node(self, node) -> None:
        self.network.clog_node(self._nid(node))

    def unclog_node(self, node) -> None:
        self.network.unclog_node(self._nid(node))

    def clog_link(self, a, b) -> None:
        """Block both directions between a and b (a partition edge)."""
        a, b = self._nid(a), self._nid(b)
        self.network.clog_link(a, b)
        self.network.clog_link(b, a)

    def unclog_link(self, a, b) -> None:
        a, b = self._nid(a), self._nid(b)
        self.network.unclog_link(a, b)
        self.network.unclog_link(b, a)

    def clog_link_one_way(self, src, dst) -> None:
        self.network.clog_link(self._nid(src), self._nid(dst))

    def unclog_link_one_way(self, src, dst) -> None:
        self.network.unclog_link(self._nid(src), self._nid(dst))

    # ---- gray failures + duplication (madsim_tpu_torch.chaos) ----------------
    def slow_link(self, a, b, mult: int) -> None:
        """Gray failure: multiply a<->b latency by ``mult`` (both
        directions, like clog_link; mult <= 1 restores). The asyncio
        hook behind the engine's KIND_SLOW_LINK."""
        a, b = self._nid(a), self._nid(b)
        self.network.set_slow_link(a, b, mult)
        self.network.set_slow_link(b, a, mult)

    def unslow_link(self, a, b) -> None:
        self.slow_link(a, b, 1)

    def slow_node(self, node, mult: int) -> None:
        """Slow every link in or out of the node (mult <= 1 restores)."""
        self.network.set_slow_node(self._nid(node), mult)

    def set_duplicate(self, on: bool) -> None:
        """Message duplication (KIND_DUP_ON analog): while set, every
        datagram delivery also schedules a second copy with its own
        independent loss/latency draw."""
        self._duplicate = bool(on)

    def update_config(self, f: Callable) -> None:
        """Mutate the live network config (mod.rs:131-136) — e.g.
        ``netsim.update_config(lambda c: setattr(c, "packet_loss_rate",
        0.2))``; the fault model reads it per send, so changes apply to
        every subsequent message."""
        f(self.network.config)

    def clog_node_in(self, node) -> None:
        """Block messages TO the node; its own sends still flow
        (mod.rs:183-186)."""
        self.network.clog_node_in(self._nid(node))

    def unclog_node_in(self, node) -> None:
        self.network.unclog_node_in(self._nid(node))

    def clog_node_out(self, node) -> None:
        """Block messages FROM the node; deliveries to it still flow
        (mod.rs:188-192)."""
        self.network.clog_node_out(self._nid(node))

    def unclog_node_out(self, node) -> None:
        self.network.unclog_node_out(self._nid(node))

    # naming-parity aliases (mod.rs:152-213): connect/disconnect are the
    # reference's names for unclog/clog of a node, connect2/disconnect2
    # for a link (both directions)
    def connect(self, node) -> None:
        self.unclog_node(node)

    def disconnect(self, node) -> None:
        self.clog_node(node)

    def connect2(self, a, b) -> None:
        self.unclog_link(a, b)

    def disconnect2(self, a, b) -> None:
        self.clog_link(a, b)

    def _install_typed_hook(
        self, hooks: dict, node, typ: type, f, is_rsp: bool, kind: str
    ) -> None:
        """Shared body of hook_rpc_req/hook_rpc_rsp: one hook per node
        (insert overwrites, None removes — the reference's HashMap
        insert, mod.rs:228/251). RPC frames are discriminated by the
        bit-63 response-tag invariant rpc.py guarantees (rpc.py:48):
        requests are ("dgram", req_tag, (obj, data, resp_tag&bit63)),
        responses are ("dgram", resp_tag&bit63, (obj, data)) — plain
        same-shape datagrams never match."""
        nid = self._nid(node)
        if f is None:
            hooks.pop(nid, None)
            return

        def hook(msg: object) -> bool:
            if not (isinstance(msg, tuple) and len(msg) == 3 and msg[0] == "dgram"):
                return True
            tag, payload = msg[1], msg[2]
            if is_rsp:
                is_frame = (
                    isinstance(tag, int) and tag >> 63
                    and isinstance(payload, tuple) and len(payload) == 2
                )
            else:
                is_frame = (
                    isinstance(payload, tuple) and len(payload) == 3
                    and isinstance(payload[2], int) and payload[2] >> 63
                )
            if is_frame and isinstance(payload[0], typ):
                try:
                    return bool(f(payload[0]))
                except Exception as exc:
                    # attribute a raising hook clearly (a rsp hook runs
                    # inside the delivery timer, outside any task)
                    raise RuntimeError(f"{kind} hook raised: {exc!r}") from exc
            return True

        hooks[nid] = hook

    def hook_rpc_req(self, node, req_type: type, f: Callable) -> None:
        """Install THE request hook for ``node`` (one per node, insert
        overwrites — mod.rs:223-240): RPC requests of ``req_type`` SENT
        BY ``node`` are dropped when ``f(req)`` returns False. Pass
        ``f=None`` to remove."""
        self._install_typed_hook(
            self._hooks_req, node, req_type, f, is_rsp=False,
            kind="hook_rpc_req",
        )

    def hook_rpc_rsp(self, node, rsp_type: type, f: Callable) -> None:
        """Install THE response hook for ``node`` (mod.rs:242-264): RPC
        responses of ``rsp_type`` about to be DELIVERED TO ``node`` are
        dropped when ``f(rsp)`` returns False. Pass ``f=None`` to
        remove."""
        self._install_typed_hook(
            self._hooks_rsp, node, rsp_type, f, is_rsp=True,
            kind="hook_rpc_rsp",
        )

    def add_send_hook(self, hook: Callable[[int, SocketAddr, object], bool]) -> int:
        """Register a chaos hook consulted before every datagram send;
        return False from the hook to drop the message (the analog of the
        RPC req/rsp drop hooks, mod.rs:223-262). Returns a hook id."""
        hook_id = self._next_hook_id
        self._next_hook_id += 1
        self._send_hooks[hook_id] = hook
        return hook_id

    def remove_send_hook(self, hook_id: int) -> None:
        self._send_hooks.pop(hook_id, None)

    # ---- send path (mod.rs:265-302) ------------------------------------
    def rand_delay(self) -> SimFuture:
        """Random 0-5 us processing delay before each network op."""
        delay = self.rng.randrange(0, _MAX_PROCESSING_DELAY_NS)
        fut = SimFuture(name="rand_delay")
        self.time.add_timer_at(self.time.now_ns() + delay, fut.set_result)
        return fut

    async def send(
        self,
        src_node: int,
        src_addr: SocketAddr,
        dst: SocketAddr,
        proto: str,
        msg: object,
    ) -> None:
        """Datagram send: processing delay -> hooks -> fault model ->
        latency timer -> ``Socket.deliver`` (mod.rs:273-302). Loss, clog
        and missing destination all drop silently, like UDP."""
        await self.rand_delay()
        req_hook = self._hooks_req.get(src_node)
        if req_hook is not None and not req_hook(msg):
            return
        for hook in list(self._send_hooks.values()):
            if not hook(src_node, dst, msg):
                return
        deliveries = []
        res = self.network.try_send(src_node, dst, proto)
        if res is not None:
            deliveries.append(res)
        if self._duplicate:
            # duplication chaos: a second copy routed independently —
            # its own loss coin and latency draw, like a real duplicate
            # in flight (the engine's dup shadow rows)
            res2 = self.network.try_send(src_node, dst, proto)
            if res2 is not None:
                deliveries.append(res2)
        for sock, dst_node, latency in deliveries:
            # rsp hook captured at send, consulted at delivery time like
            # the reference's timer closure (mod.rs:291-297)
            rsp_hook = self._hooks_rsp.get(dst_node)

            def deliver(sock=sock, rsp_hook=rsp_hook) -> None:
                if rsp_hook is not None and not rsp_hook(msg):
                    return
                # visible source address: loopback stays loopback
                sock.deliver(src_addr, dst, msg)

            self.time.add_timer_at(self.time.now_ns() + latency, deliver)

    # ---- reliable connection machinery (mod.rs:306-365) ----------------
    def register_pipe(self, pipe: Pipe) -> None:
        self._pipes_by_node.setdefault(pipe.src_node, {})[pipe] = None
        self._pipes_by_node.setdefault(pipe.dst_node, {})[pipe] = None
        pipe.on_close = self._unregister_pipe

    def _unregister_pipe(self, pipe: Pipe) -> None:
        self._pipes_by_node.get(pipe.src_node, {}).pop(pipe, None)
        self._pipes_by_node.get(pipe.dst_node, {}).pop(pipe, None)

    async def wait_unclogged(self, src: int, dst: int) -> None:
        """Exponential backoff while the link is clogged
        (1 ms -> 10 s, mod.rs:341-355)."""
        backoff = _BACKOFF_MIN_NS
        while self.network.is_clogged(src, dst):
            fut = SimFuture(name="backoff")
            self.time.add_timer_at(self.time.now_ns() + backoff, fut.set_result)
            await fut
            backoff = min(backoff * 2, _BACKOFF_MAX_NS)

    async def deliver_reliable(self, src: int, dst: int, deliver: Callable[[], None]) -> None:
        """Reliable in-order delivery: wait out clogs, then apply one-way
        latency (connections never drop packets; TCP-like semantics)."""
        await self.wait_unclogged(src, dst)
        lo = round(self.config.net.send_latency[0] * NANOS_PER_SEC)
        hi = round(self.config.net.send_latency[1] * NANOS_PER_SEC)
        # gray failure scales the drawn latency (post-draw, so the RNG
        # stream is identical with or without the slow link)
        latency = self.rng.randrange(lo, max(hi, lo + 1)) * self.network.slow_mult(
            src, dst
        )
        fut = SimFuture(name="conn_latency")
        self.time.add_timer_at(self.time.now_ns() + latency, fut.set_result)
        await fut
        deliver()

    def spawn_pump(self, out_pipe: Pipe, in_pipe: Pipe) -> None:
        """Pump task moving messages out_pipe -> in_pipe, spawned on the
        sending node so it dies with the node (mod.rs:329-365)."""

        async def pump():
            while True:
                item = await out_pipe.pop()
                if item is None:  # closed and drained
                    in_pipe.close()
                    return
                await self.deliver_reliable(
                    out_pipe.src_node, out_pipe.dst_node, lambda it=item: in_pipe.push(it)
                )

        executor = self.handle.executor
        node_info = executor.nodes[out_pipe.src_node]
        executor.spawn_on(node_info, pump(), name=f"pump:{out_pipe.src_node}->{out_pipe.dst_node}")

    @staticmethod
    def current() -> "NetSim":
        """The current runtime's NetSim instance."""
        return context.current_handle().simulator(NetSim)
