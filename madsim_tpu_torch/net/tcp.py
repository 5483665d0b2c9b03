"""TCP stream simulator: byte streams over NetSim connections.

Parity with reference madsim/src/sim/net/tcp/:
  * ``TcpListener.bind`` / ``accept`` hand out fully-formed streams
    (listener.rs:35-95).
  * ``TcpStream`` buffers writes locally and transmits on ``flush``
    (stream.rs:146-163 — ``poll_write`` buffers, ``poll_flush`` sends);
    reads buffer incoming chunks and serve partial reads
    (stream.rs:118-142).
  * a peer node reset closes the stream: reads return EOF (b"") and
    writes raise — the partition/reset semantics tested by the reference
    (tcp/mod.rs:98-208).

Streams ride the same reliable in-order connection pipes as Endpoint
``connect1``/``accept1``, so clog/unclog stalls and resumes byte streams
exactly like the reference's TCP sim.
"""

from __future__ import annotations

from typing import Optional

from .addr import AddrLike, SocketAddr, parse_addr
from .endpoint import Endpoint, PipeReceiver, PipeSender
from .network import Protocols

__all__ = ["TcpListener", "TcpStream"]


class TcpStream:
    def __init__(
        self,
        tx: PipeSender,
        rx: PipeReceiver,
        local_addr: SocketAddr,
        peer_addr: SocketAddr,
        owned_ep: Optional[Endpoint] = None,
    ):
        self._tx = tx
        self._rx = rx
        self._local = local_addr
        self._peer = peer_addr
        self._wbuf = bytearray()
        self._rbuf = bytearray()
        self._eof = False
        # the ephemeral endpoint backing an outbound connection — unbound
        # on close so connection churn doesn't exhaust the port space
        self._owned_ep = owned_ep

    # ---- construction ---------------------------------------------------
    @classmethod
    async def connect(cls, addr: AddrLike) -> "TcpStream":
        """Connect from the current node (stream.rs:71-91)."""
        ep = await Endpoint.bind(("0.0.0.0", 0), _proto=Protocols.TCP)
        try:
            tx, rx = await ep.connect1(addr)
        except BaseException:
            ep.close()
            raise
        return cls(tx, rx, ep.local_addr, parse_addr(addr), owned_ep=ep)

    @property
    def local_addr(self) -> SocketAddr:
        return self._local

    @property
    def peer_addr(self) -> SocketAddr:
        return self._peer

    # ---- write side (stream.rs:146-163) ---------------------------------
    async def write(self, data: bytes) -> int:
        """Buffer bytes locally; nothing is transmitted until flush."""
        self._wbuf.extend(data)
        return len(data)

    async def flush(self) -> None:
        if not self._wbuf:
            return
        chunk = bytes(self._wbuf)
        self._wbuf.clear()
        await self._tx.send(chunk)

    async def write_all(self, data: bytes) -> None:
        await self.write(data)
        await self.flush()

    # ---- read side (stream.rs:118-142) ----------------------------------
    async def read(self, n: int) -> bytes:
        """Up to ``n`` bytes; b"" on EOF (peer closed or node reset)."""
        if n <= 0:
            return b""
        while not self._rbuf:
            if self._eof:
                return b""
            chunk = await self._rx.recv()
            if chunk is None:
                self._eof = True
                return b""
            self._rbuf.extend(chunk)
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    async def read_exact(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            chunk = await self.read(n - len(out))
            if not chunk:
                raise ConnectionResetError(
                    f"connection closed with {n - len(out)} bytes still expected"
                )
            out.extend(chunk)
        return bytes(out)

    def set_nodelay(self, _nodelay: bool = True) -> None:
        """Accepted and ignored, like the reference's simulated socket
        (stream.rs:94-98) — the sim has no Nagle buffering to disable."""

    def shutdown(self) -> None:
        """Close the write half; the peer sees EOF after in-flight data.
        The read half keeps working (TCP half-close)."""
        self._tx.shutdown()

    def close(self) -> None:
        """Close the whole stream, releasing both directions' resources.
        Reset-like: a peer blocked in ``read`` wakes with EOF immediately,
        even if sent bytes are still in flight (the node-reset semantics
        of tcp/mod.rs:98-208)."""
        self._tx.close()
        if self._owned_ep is not None:
            self._owned_ep.close()
            self._owned_ep = None

    def close_graceful(self) -> None:
        """FIN-like close: the write half shuts down, so the peer sees
        EOF only AFTER all in-flight bytes deliver (real-TCP close
        ordering — the asyncio transport layer needs this; plain
        ``close`` is a reset). Our own future reads return EOF; the
        reverse-direction pipes close when the peer closes its end."""
        self._tx.shutdown()
        self._eof = True
        if self._owned_ep is not None:
            self._owned_ep.close()
            self._owned_ep = None


class TcpListener:
    def __init__(self, ep: Endpoint):
        self._ep = ep

    @classmethod
    async def bind(cls, addr: AddrLike) -> "TcpListener":
        # TCP ports live in their own namespace (network.rs keys sockets
        # by (addr, protocol)), so a UDP socket and TCP listener coexist
        # on the same port number.
        return cls(await Endpoint.bind(addr, _proto=Protocols.TCP))

    @property
    def local_addr(self) -> SocketAddr:
        return self._ep.local_addr

    async def accept(self) -> tuple[TcpStream, SocketAddr]:
        tx, rx, peer = await self._ep.accept1()
        return TcpStream(tx, rx, self._ep.local_addr, peer), peer
