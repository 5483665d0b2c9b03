"""Endpoint — tag-matching messaging, the core transport primitive.

Parity with reference madsim/src/sim/net/endpoint.rs:
  * UDP-like *tagged datagrams* whose payload is any Python object,
    zero-copy within the process (the analog of ``Payload = Box<dyn Any>``
    — no serialization in simulation, endpoint.rs:13-172).
  * a ``Mailbox`` that matches incoming messages to pending receivers by
    tag, or queues them (endpoint.rs:288-353).
  * reliable ordered "connections" via ``connect1``/``accept1`` returning
    sender/receiver halves (endpoint.rs:176-264), pumped with clog-aware
    backoff by NetSim; a node reset closes the connection and the peer
    observes EOF.

Everything above this layer (RPC, the gRPC-like service shim, etcd- and
kafka-style simulators) is built on Endpoint, exactly as in the reference.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Optional

from ..runtime.future import SimFuture
from ..runtime.plugin import node as current_node
from .addr import AddrLike, SocketAddr, parse_addr
from .netsim import NetSim, Pipe, PipeReceiver, PipeSender
from .network import Protocols

__all__ = ["Endpoint", "PipeSender", "PipeReceiver"]


class _Mailbox:
    """Tag-matching mailbox (endpoint.rs:288-353)."""

    __slots__ = ("msgs", "waiters")

    def __init__(self) -> None:
        self.msgs: dict[int, deque[tuple[Any, SocketAddr]]] = {}
        self.waiters: dict[int, deque[SimFuture]] = {}

    def deliver(self, tag: int, payload: Any, src: SocketAddr) -> None:
        q = self.waiters.get(tag)
        while q:
            w = q.popleft()
            if not q:
                del self.waiters[tag]
            if not w.done():
                w.set_result((payload, src))
                return
        self.msgs.setdefault(tag, deque()).append((payload, src))

    def recv(self, tag: int) -> SimFuture:
        fut = SimFuture(name=f"recv:{tag}")
        q = self.msgs.get(tag)
        if q:
            payload, src = q.popleft()
            if not q:
                del self.msgs[tag]
            fut.set_result((payload, src))
        else:
            self.waiters.setdefault(tag, deque()).append(fut)
        return fut

    def drop_tag(self, tag: int) -> None:
        """Forget a tag's waiters and queued messages — used to clean up
        per-call response tags after an RPC timeout so the mailbox does
        not grow with every failed call."""
        self.waiters.pop(tag, None)
        self.msgs.pop(tag, None)


class _EndpointSocket:
    """Network-registered delivery target (endpoint.rs:301-341)."""

    __slots__ = ("endpoint",)

    def __init__(self, endpoint: "Endpoint"):
        self.endpoint = endpoint

    def deliver(self, src: SocketAddr, dst: SocketAddr, msg: object) -> None:
        kind = msg[0]
        if kind == "dgram":
            _, tag, payload = msg
            self.endpoint._mailbox.deliver(tag, payload, src)
        elif kind == "conn":
            _, conn = msg
            self.endpoint._deliver_conn(conn)


class _Conn:
    """Shared connection record exchanged at setup (zero-copy)."""

    __slots__ = ("out_ab", "in_ab", "out_ba", "in_ba", "client_addr")

    def __init__(self, out_ab: Pipe, in_ab: Pipe, out_ba: Pipe, in_ba: Pipe, client_addr: SocketAddr):
        self.out_ab = out_ab
        self.in_ab = in_ab
        self.out_ba = out_ba
        self.in_ba = in_ba
        self.client_addr = client_addr


class Endpoint:
    """Bind with ``await Endpoint.bind("0.0.0.0:5000")`` on a node task."""

    def __init__(self, netsim: NetSim, node_id: int, addr: SocketAddr, proto: str = Protocols.EP):
        self._net = netsim
        self._node = node_id
        self._addr = addr
        self._proto = proto
        self._mailbox = _Mailbox()
        self._accept_backlog: deque[_Conn] = deque()
        self._accept_waiters: deque[SimFuture] = deque()
        self._peer: Optional[SocketAddr] = None

    # ---- construction ---------------------------------------------------
    @classmethod
    async def bind(cls, addr: AddrLike, *, _proto: str = Protocols.EP) -> "Endpoint":
        """Bind on the current node (endpoint.rs:23-37). Port 0 allocates
        an ephemeral port. Ports are namespaced per protocol (the network
        keys sockets by ``(addr, protocol)``, network.rs:24-70), so the
        TCP/UDP sims bind their own namespaces and coexist with Endpoint
        on the same port number."""
        netsim = NetSim.current()
        node_id = current_node()
        req = parse_addr(addr)
        ep = cls(netsim, node_id, req, _proto)
        bound = netsim.network.bind(node_id, req, _proto, _EndpointSocket(ep))
        ep._addr = bound
        return ep

    @classmethod
    async def connect(cls, dst: AddrLike) -> "Endpoint":
        """Bind an ephemeral endpoint whose default peer is ``dst``
        (endpoint.rs:39-45); ``send``/``recv`` then omit the address."""
        ep = await cls.bind("0.0.0.0:0")
        ep._peer = parse_addr(dst)
        return ep

    @property
    def local_addr(self) -> SocketAddr:
        return self._addr

    @property
    def peer_addr(self) -> SocketAddr:
        """The connected peer (endpoint.rs:52-58); raises if the
        endpoint was bound rather than connected."""
        if self._peer is None:
            raise OSError("endpoint is not connected")
        return self._peer

    async def send(self, tag: int, payload: Any) -> None:
        """Send to the connected peer (endpoint.rs:96-101)."""
        await self.send_to(self.peer_addr, tag, payload)

    async def recv(self, tag: int) -> Any:
        """Receive a matching datagram from the connected peer
        (endpoint.rs:103-113): errors on an unconnected endpoint, and
        like the reference, a matching datagram from any OTHER source is
        an error — misdelivery surfaces instead of masquerading as the
        peer."""
        peer = self.peer_addr
        payload, src = await self.recv_from(tag)
        if src != peer:
            raise OSError(
                f"received tag {tag} from {src}, not the connected peer {peer}"
            )
        return payload

    def close(self) -> None:
        """Unbind from the network, releasing the socket-table entry
        (Network::close, network.rs:261). Ephemeral per-connection
        endpoints (e.g. TcpStream.connect) must call this or the node's
        port space leaks one entry per connect."""
        self._net.network.close(self._node, self._addr, self._proto)

    def _visible_src(self, dst_ip: str) -> SocketAddr:
        """Source address as seen by the receiver: loopback for local
        destinations, the node IP otherwise. A node without an assigned IP
        cannot address remote peers — fail loudly instead of silently
        misrouting replies."""
        ip, port = self._addr
        if dst_ip in ("127.0.0.1", "localhost"):
            return ("127.0.0.1", port)
        node_ip = self._net.network.ip_of(self._node)
        if node_ip is None:
            raise OSError(
                f"node {self._node} has no IP address; give it one with "
                f"create_node().ip(...) before sending to remote peers"
            )
        return (node_ip, port)

    # ---- tagged datagrams (endpoint.rs:68-147) --------------------------
    async def send_to(
        self, dst: AddrLike, tag: int, payload: Any, *, _reserved: bool = False
    ) -> None:
        """Send one tagged datagram; silently dropped on loss/partition
        like the reference's UDP-style sends.

        Tags with bit 63 set are reserved for RPC response frames
        (rpc.py draws response tags in that space; the typed RPC hooks
        discriminate frames by it) — user sends may not use them."""
        if not _reserved and isinstance(tag, int) and tag >> 63:
            raise ValueError(
                "tags >= 2**63 are reserved for RPC response frames"
            )
        dst_a = parse_addr(dst)
        await self._net.send(
            self._node,
            self._visible_src(dst_a[0]),
            dst_a,
            self._proto,
            ("dgram", tag, payload),
        )

    async def recv_from(self, tag: int) -> tuple[Any, SocketAddr]:
        """Receive the next datagram matching ``tag``
        (endpoint.rs:86-111, 343-352)."""
        payload, src = await self._mailbox.recv(tag)
        await self._net.rand_delay()
        return payload, src

    def try_recv_from(self, tag: int) -> Optional[tuple[Any, SocketAddr]]:
        q = self._mailbox.msgs.get(tag)
        if q:
            payload, src = q.popleft()
            if not q:
                del self._mailbox.msgs[tag]
            return payload, src
        return None

    # ---- connections (endpoint.rs:176-264) ------------------------------
    async def connect1(self, dst: AddrLike) -> tuple[PipeSender, PipeReceiver]:
        """Open a reliable ordered connection to a bound peer endpoint.

        Raises ConnectionRefusedError when no endpoint is bound at ``dst``.
        Blocks (with clog backoff) until the setup message reaches the
        peer's backlog — TCP-handshake-like semantics."""
        net = self._net
        await net.rand_delay()
        dst_a = parse_addr(dst)
        dst_node = net.network.resolve_dest_node(dst_a[0], self._node)
        if dst_node is None:
            raise ConnectionRefusedError(f"no route to {dst_a[0]}:{dst_a[1]}")
        sock = net.network.lookup_socket(dst_node, dst_a, self._proto)
        if sock is None or not isinstance(sock, _EndpointSocket):
            raise ConnectionRefusedError(f"connection refused: {dst_a[0]}:{dst_a[1]}")

        a, b = self._node, dst_node
        out_ab, in_ab = Pipe(a, b), Pipe(a, b)
        out_ba, in_ba = Pipe(b, a), Pipe(b, a)
        group = (out_ab, in_ab, out_ba, in_ba)
        conn = _Conn(out_ab, in_ab, out_ba, in_ba, self._visible_src(dst_a[0]))
        for p in group:
            p.group = group
            net.register_pipe(p)
        net.spawn_pump(out_ab, in_ab)
        # Handshake: the setup message travels reliably (no loss draw, but
        # clog blocks it) and lands in the peer's accept backlog.
        await net.deliver_reliable(a, b, lambda: sock.deliver(conn.client_addr, dst_a, ("conn", conn)))
        return PipeSender(out_ab), PipeReceiver(in_ba)

    def _deliver_conn(self, conn: _Conn) -> None:
        while self._accept_waiters:
            w = self._accept_waiters.popleft()
            if not w.done():
                w.set_result(conn)
                return
        self._accept_backlog.append(conn)

    async def accept1(self) -> tuple[PipeSender, PipeReceiver, SocketAddr]:
        """Accept one connection (endpoint.rs:198-209): returns
        (sender, receiver, peer_addr)."""
        if self._accept_backlog:
            conn = self._accept_backlog.popleft()
        else:
            fut = SimFuture(name="accept")
            self._accept_waiters.append(fut)
            conn = await fut
        # pump for our -> client direction runs on our node
        self._net.spawn_pump(conn.out_ba, conn.in_ba)
        return PipeSender(conn.out_ba), PipeReceiver(conn.in_ab), conn.client_addr

    # ---- typed RPC sugar (C12; implemented in net/rpc.py) ---------------
    async def call(self, dst: AddrLike, req: Any, timeout: Optional[float] = None) -> Any:
        # import the submodule explicitly: the package re-exports the @rpc
        # decorator under the same name, shadowing `from . import rpc`
        from .rpc import call as rpc_call

        return await rpc_call(self, dst, req, timeout=timeout)

    async def call_with_data(
        self, dst: AddrLike, req: Any, data: bytes, timeout: Optional[float] = None
    ) -> tuple[Any, bytes]:
        from .rpc import call_with_data as rpc_call_with_data

        return await rpc_call_with_data(self, dst, req, data, timeout=timeout)

    def add_rpc_handler(self, req_type: type, handler) -> None:
        from .rpc import add_rpc_handler as rpc_add

        rpc_add(self, req_type, handler)

    def add_rpc_handler_with_data(self, req_type: type, handler) -> None:
        from .rpc import add_rpc_handler_with_data as rpc_add_wd

        rpc_add_wd(self, req_type, handler)
