"""Unix-domain socket simulator: path-addressed node-local IPC.

The reference ships only hidden-doc ``todo!()`` stubs here
(madsim/src/sim/net/unix/stream.rs:16-45, datagram.rs:6 — C15); this
implementation goes beyond parity. Semantics chosen to match real unix
sockets mapped onto the simulation model:

  * paths are **node-local**: a bind on node A is invisible to node B,
    exactly as filesystem paths don't cross machines.
  * transfers are local IPC — no latency/loss/clog draws (network chaos
    does not touch same-machine sockets) — but every socket dies with
    its node: kill/restart closes streams (peer reads EOF) and unbinds
    paths, riding the same pipe-reset machinery as TCP connections.
  * streams support half-close and EOF like the TCP sim; datagrams are
    unreliable-in-principle but never dropped (loopback).

Streams reuse the connection :class:`~madsim_tpu_torch.net.netsim.Pipe`
machinery; the byte-stream façade mirrors ``TcpStream``.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from ..runtime.future import SimFuture
from ..runtime.plugin import node as current_node
from .netsim import NetSim, Pipe, PipeReceiver, PipeSender
from .tcp import TcpStream

__all__ = ["UnixDatagram", "UnixListener", "UnixStream"]


def _key(path: str) -> tuple[int, str]:
    if not path:
        raise ValueError("unix socket path must be non-empty")
    return (current_node(), str(path))


class UnixStream(TcpStream):
    """Byte stream over a unix path (stream.rs API shape).

    Inherits the buffered read/write/flush/half-close behavior from the
    TCP sim; only addressing and connection setup differ.
    """

    def __init__(self, tx: PipeSender, rx: PipeReceiver, local_path: str, peer_path: str):
        super().__init__(tx, rx, local_path, peer_path)  # type: ignore[arg-type]

    @classmethod
    async def connect(cls, path: str) -> "UnixStream":
        """Connect to a listener bound at ``path`` on the *current* node."""
        net = NetSim.current()
        key = _key(path)
        await net.rand_delay()
        listener = net.unix_binds.get(key)
        if not isinstance(listener, UnixListener):
            raise ConnectionRefusedError(f"no unix listener at {path!r}")
        node = key[0]
        # one pipe per direction; local IPC pushes directly (no pump, no
        # latency draw) but registration ties lifetime to the node
        a2b, b2a = Pipe(node, node), Pipe(node, node)
        group = (a2b, b2a)
        for p in group:
            p.group = group
            net.register_pipe(p)
        stream = cls(PipeSender(a2b), PipeReceiver(b2a), "", path)
        listener._deliver(a2b, b2a)
        return stream

    @property
    def local_path(self) -> str:
        return self._local  # type: ignore[return-value]

    @property
    def peer_path(self) -> str:
        return self._peer  # type: ignore[return-value]


class UnixListener:
    def __init__(self, net: NetSim, key: tuple[int, str]):
        self._net = net
        self._key = key
        self._backlog: deque[tuple[Pipe, Pipe]] = deque()
        self._waiters: deque[SimFuture] = deque()
        self._closed = False

    @classmethod
    async def bind(cls, path: str) -> "UnixListener":
        net = NetSim.current()
        key = _key(path)
        if key in net.unix_binds:
            raise OSError(f"address already in use: unix path {path!r}")
        listener = cls(net, key)
        net.unix_binds[key] = listener
        return listener

    @property
    def local_path(self) -> str:
        return self._key[1]

    def _deliver(self, a2b: Pipe, b2a: Pipe) -> None:
        while self._waiters:
            w = self._waiters.popleft()
            if not w.done():
                w.set_result((a2b, b2a))
                return
        self._backlog.append((a2b, b2a))

    async def accept(self) -> tuple[UnixStream, str]:
        if self._closed:
            raise OSError("listener is closed")
        if self._backlog:
            a2b, b2a = self._backlog.popleft()
        else:
            fut = SimFuture(name="unix.accept")
            self._waiters.append(fut)
            res = await fut
            if res is None:
                raise ConnectionResetError("listener closed while accepting")
            a2b, b2a = res
        stream = UnixStream(PipeSender(b2a), PipeReceiver(a2b), self._key[1], "")
        return stream, ""

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._net.unix_binds.pop(self._key, None)
        while self._waiters:
            w = self._waiters.popleft()
            if not w.done():
                w.set_result(None)
        for a2b, b2a in self._backlog:
            a2b.close()
            b2a.close()
        self._backlog.clear()

    def _on_node_reset(self) -> None:
        """Node kill/restart: pending accepts fail, backlog closes.
        (Established streams close via the pipe registry.)"""
        self._closed = True
        while self._waiters:
            w = self._waiters.popleft()
            if not w.done():
                w.set_result(None)
        self._backlog.clear()


class UnixDatagram:
    """Datagram socket over unix paths (datagram.rs API shape)."""

    def __init__(self, net: NetSim, key: Optional[tuple[int, str]]):
        self._net = net
        self._key = key  # None = anonymous (unbound) socket
        self._queue: deque[tuple[bytes, str]] = deque()
        self._waiters: deque[SimFuture] = deque()
        self._peer: Optional[str] = None
        self._closed = False

    @classmethod
    async def bind(cls, path: str) -> "UnixDatagram":
        net = NetSim.current()
        key = _key(path)
        if key in net.unix_binds:
            raise OSError(f"address already in use: unix path {path!r}")
        sock = cls(net, key)
        net.unix_binds[key] = sock
        return sock

    @classmethod
    async def unbound(cls) -> "UnixDatagram":
        """An anonymous socket: can send, cannot be addressed."""
        return cls(NetSim.current(), None)

    @property
    def local_path(self) -> str:
        return self._key[1] if self._key else ""

    async def connect(self, path: str) -> None:
        """Set the default destination for :meth:`send`."""
        self._peer = str(path)

    async def send_to(self, data: bytes, path: str) -> int:
        if self._closed:
            raise OSError("socket is closed")
        net = self._net
        key = _key(path)
        await net.rand_delay()
        dst = net.unix_binds.get(key)
        if not isinstance(dst, UnixDatagram):
            raise ConnectionRefusedError(f"no unix datagram socket at {path!r}")
        dst._deliver(bytes(data), self.local_path)
        return len(data)

    async def send(self, data: bytes) -> int:
        if self._peer is None:
            raise OSError("socket is not connected")
        return await self.send_to(data, self._peer)

    def _deliver(self, data: bytes, src: str) -> None:
        while self._waiters:
            w = self._waiters.popleft()
            if not w.done():
                w.set_result((data, src))
                return
        self._queue.append((data, src))

    async def recv_from(self) -> tuple[bytes, str]:
        if self._queue:
            return self._queue.popleft()
        if self._closed:
            raise OSError("socket is closed")
        fut = SimFuture(name="unix.recv")
        self._waiters.append(fut)
        res = await fut
        if res is None:
            raise ConnectionResetError("socket closed while receiving")
        return res

    async def recv(self) -> bytes:
        data, _src = await self.recv_from()
        return data

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._key is not None:
            self._net.unix_binds.pop(self._key, None)
        while self._waiters:
            w = self._waiters.popleft()
            if not w.done():
                w.set_result(None)

    def _on_node_reset(self) -> None:
        self.close()
