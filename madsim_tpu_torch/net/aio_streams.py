"""Raw asyncio streams over the simulated network.

The transport half of the loop interposition (runtime/aio.py): stdlib
``asyncio.open_connection`` / ``asyncio.start_server`` call
``loop.create_connection`` / ``loop.create_server`` on the running
loop — inside a simulation that is the :class:`SimEventLoop`, which
delegates here. A :class:`SimTransport` adapts the byte-stream TCP
simulator (net/tcp.py — NetSim latency/loss/clog/partition semantics,
reference sim/net/tcp/) to asyncio's Transport/Protocol contract, so
the stdlib's OWN ``StreamReader``/``StreamWriter``/
``StreamReaderProtocol`` machinery runs unmodified against the
simulated network: an asyncio echo server written purely with
``asyncio.start_server`` accepts simulated connections, sees simulated
latency, and dies with its simulated node.

This is the analog of the reference simulating tokio's TcpStream under
the same API (sim/net/tcp/stream.rs): user network code unchanged,
bytes riding the deterministic network.
"""

from __future__ import annotations

import asyncio as _aio
from typing import Callable, Optional

from ..runtime.task import spawn
from .addr import lookup_host, parse_addr
from .tcp import TcpListener, TcpStream
from .udp import UdpSocket

__all__ = [
    "SimTransport",
    "SimDatagramTransport",
    "SimServer",
    "create_connection",
    "create_server",
    "create_datagram_endpoint",
]

_READ_CHUNK = 64 * 1024


class SimTransport:
    """asyncio.Transport over a simulated TcpStream.

    Writes are synchronous per the Transport contract: bytes land in an
    ordered queue drained by a writer pump task (one flush per queued
    chunk, preserving order); reads run in a reader pump that feeds
    ``protocol.data_received`` and honors ``pause_reading``.
    """

    def __init__(self, loop, stream: TcpStream, protocol, on_lost=None):
        self._loop = loop
        self._stream = stream
        self._protocol = protocol
        self._on_lost = on_lost  # server book-keeping (connection churn)
        self._closing = False
        self._closed = False
        self._eof_sent = False
        self._write_q: list[Optional[bytes]] = []  # None = shutdown marker
        self._write_wake = _aio.Event()
        self._read_paused = _aio.Event()
        self._read_paused.set()  # set = reading allowed
        self._pumps = []

    # -- wiring ------------------------------------------------------------
    def _start(self) -> None:
        self._protocol.connection_made(self)
        self._pumps.append(spawn(self._read_pump(), name="tcp-read-pump"))
        self._pumps.append(spawn(self._write_pump(), name="tcp-write-pump"))

    async def _read_pump(self) -> None:
        try:
            while not self._closed:
                await self._read_paused.wait()
                data = await self._stream.read(_READ_CHUNK)
                if not data:
                    # EOF: peer half-closed (or reset). eof_received()
                    # returning true means KEEP the transport open for
                    # writes (TCP half-close — StreamReaderProtocol does
                    # this), so request/EOF/response exchanges work;
                    # falsy = tear down, as real transports do
                    keep = False
                    try:
                        keep = bool(self._protocol.eof_received())
                    finally:
                        if not keep:
                            self._drop(None)
                    return
                self._protocol.data_received(data)
        except ConnectionError as exc:
            self._drop(exc)

    async def _write_pump(self) -> None:
        try:
            while True:
                while not self._write_q:
                    if self._closing:
                        # graceful close: every queued write has been
                        # flushed — FIN after data, never a reset
                        self._drop(None, graceful=True)
                        return
                    self._write_wake.clear()
                    await self._write_wake.wait()
                item = self._write_q.pop(0)
                if item is None:
                    self._stream.shutdown()  # half-close: EOF after data
                    continue
                await self._stream.write_all(item)
        except ConnectionError as exc:
            self._drop(exc)

    def _drop(self, exc: Optional[BaseException], graceful: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        if graceful:
            self._stream.close_graceful()
        else:
            self._stream.close()
        try:
            self._protocol.connection_lost(exc)
        finally:
            if self._on_lost is not None:
                self._on_lost(self)
            for p in self._pumps:
                if not p.done():
                    p.abort()

    # -- asyncio.Transport surface ----------------------------------------
    def get_extra_info(self, name: str, default=None):
        # SocketAddr is already the ``(ip, port)`` tuple (net/addr.py)
        if name == "peername":
            return self._stream.peer_addr
        if name == "sockname":
            return self._stream.local_addr
        return default

    def write(self, data: bytes) -> None:
        if self._eof_sent:
            # loud like real transports — a silent drop here would let a
            # buggy test pass in sim and fail in production
            raise RuntimeError("Cannot call write() after write_eof()")
        if self._closing or self._closed:
            return  # real transports warn-and-drop after close
        if data:
            self._write_q.append(bytes(data))
            self._write_wake.set()

    def writelines(self, chunks) -> None:
        self.write(b"".join(chunks))

    def can_write_eof(self) -> bool:
        return True

    def write_eof(self) -> None:
        if self._eof_sent or self._closed:
            return
        self._eof_sent = True
        self._write_q.append(None)
        self._write_wake.set()

    def is_closing(self) -> bool:
        return self._closing or self._closed

    def close(self) -> None:
        """Graceful: pending writes flush, then the connection drops."""
        if self._closing or self._closed:
            return
        self._closing = True
        self._write_wake.set()

    def abort(self) -> None:
        self._drop(None)

    # flow control (StreamReader buffer limits call these)
    def pause_reading(self) -> None:
        self._read_paused.clear()

    def resume_reading(self) -> None:
        self._read_paused.set()

    def is_reading(self) -> bool:
        return self._read_paused.is_set()

    # write flow control introspection (StreamWriter.drain consults the
    # protocol, which only pauses if WE call pause_writing — we never
    # do: the simulated send buffer is unbounded like the reference's)
    def get_write_buffer_size(self) -> int:
        return sum(len(c) for c in self._write_q if c)

    def get_write_buffer_limits(self) -> tuple:
        return (0, 0)

    def set_write_buffer_limits(self, high=None, low=None) -> None:
        pass


class SimDatagramTransport:
    """asyncio.DatagramTransport over the simulated UdpSocket: backs raw
    ``loop.create_datagram_endpoint`` — stdlib DatagramProtocol code
    (``datagram_received``/``error_received``) runs against NetSim's
    datagram loss/latency/partition model (udp.rs:9-73 parity)."""

    def __init__(self, loop, sock: UdpSocket, protocol, remote):
        self._loop = loop
        self._sock = sock
        self._protocol = protocol
        self._remote = remote  # (ip, port) filter for connected sockets
        self._closing = False
        self._closed = False
        self._send_q: list[tuple[bytes, tuple]] = []
        self._send_wake = _aio.Event()
        self._pumps = []

    def _start(self) -> None:
        self._protocol.connection_made(self)
        self._pumps.append(spawn(self._recv_pump(), name="udp-recv-pump"))
        self._pumps.append(spawn(self._send_pump(), name="udp-send-pump"))

    async def _recv_pump(self) -> None:
        # stop on _closing too: asyncio removes the reader the moment
        # close() is called, even while queued sends still flush
        while not (self._closing or self._closed):
            data, src = await self._sock.recv_from()
            if self._closing or self._closed:
                return
            if self._remote is not None and src != self._remote:
                continue  # connected-socket filter (udp.py recv parity)
            self._protocol.datagram_received(data, src)

    async def _send_pump(self) -> None:
        while True:
            while not self._send_q:
                if self._closing:
                    self._teardown(None)
                    return
                self._send_wake.clear()
                await self._send_wake.wait()
            data, addr = self._send_q.pop(0)
            try:
                await self._sock.send_to(data, addr)
            except (OSError, ValueError, TypeError) as exc:
                # datagram semantics: per-packet error, transport lives
                self._protocol.error_received(exc)

    def _teardown(self, exc) -> None:
        if self._closed:
            return
        self._closed = True
        self._sock.close()
        try:
            self._protocol.connection_lost(exc)
        finally:
            for p in self._pumps:
                if not p.done():
                    p.abort()

    # -- asyncio.DatagramTransport surface --------------------------------
    def get_extra_info(self, name: str, default=None):
        if name == "sockname":
            return self._sock.local_addr
        if name == "peername":
            return self._remote
        return default

    def sendto(self, data: bytes, addr=None) -> None:
        if self._closing or self._closed:
            return
        if addr is None:
            if self._remote is None:
                raise ValueError("no address given and socket not connected")
            addr = self._remote
        else:
            # validate at the CALL SITE (a malformed addr surfacing later
            # in the send pump would fail the whole sim far from the bug)
            addr = parse_addr(addr)
            if self._remote is not None and addr != tuple(self._remote):
                raise ValueError(
                    f"invalid address: must be {self._remote} "
                    f"(connected socket)"
                )
        self._send_q.append((bytes(data), addr))
        self._send_wake.set()

    def is_closing(self) -> bool:
        return self._closing or self._closed

    def close(self) -> None:
        if self._closing or self._closed:
            return
        self._closing = True
        self._send_wake.set()  # queued datagrams flush, then teardown

    def abort(self) -> None:
        self._teardown(None)


class SimServer:
    """asyncio.Server stand-in returned by ``start_server`` in a sim."""

    def __init__(self, loop, listener: TcpListener, protocol_factory):
        self._loop = loop
        self._listener = listener
        self._factory = protocol_factory
        self._accept_task = None
        self._closed_fut = loop.create_future()
        self._serving_fut = None
        # dict-as-ordered-set: a plain set would iterate in address
        # order, making close_clients()/abort_clients() close
        # connections in a NONDETERMINISTIC order — the exact class of
        # hidden nondeterminism this simulator exists to forbid
        self._transports: dict[SimTransport, None] = {}

    @property
    def sockets(self) -> list:
        return []  # no real sockets in a simulation

    def is_serving(self) -> bool:
        return self._accept_task is not None and not self._accept_task.done()

    def _start(self) -> None:
        self._accept_task = spawn(self._accept_loop(), name="tcp-accept-loop")

    async def _accept_loop(self) -> None:
        while True:
            stream, _peer = await self._listener.accept()
            protocol = self._factory()
            # the connection-lost hook prunes the transport so churn
            # does not accumulate dead entries for the server's lifetime
            tr = SimTransport(
                self._loop, stream, protocol,
                on_lost=lambda t: self._transports.pop(t, None),
            )
            self._transports[tr] = None
            tr._start()

    async def start_serving(self) -> None:
        if not self.is_serving():
            self._start()

    async def serve_forever(self) -> None:
        if self._serving_fut is not None:
            raise RuntimeError("server is already being awaited on")
        await self.start_serving()
        self._serving_fut = self._loop.create_future()
        try:
            # pends until close() cancels it (asyncio.Server semantics:
            # close cancels the serve-forever future; CancelledError
            # propagates to the caller after cleanup)
            await self._serving_fut
        except _aio.CancelledError:
            try:
                self.close()
                await self.wait_closed()
            finally:
                raise

    def close(self) -> None:
        if self._accept_task is not None and not self._accept_task.done():
            self._accept_task.abort()
        self._listener._ep.close()
        if self._serving_fut is not None and not self._serving_fut.done():
            self._serving_fut.cancel()
        if not self._closed_fut.done():
            self._closed_fut.set_result(None)

    def close_clients(self) -> None:
        for tr in list(self._transports):
            tr.close()

    def abort_clients(self) -> None:
        for tr in list(self._transports):
            tr.abort()

    async def wait_closed(self) -> None:
        await self._closed_fut

    async def __aenter__(self) -> "SimServer":
        return self

    async def __aexit__(self, *exc) -> None:
        self.close()
        await self.wait_closed()


async def create_connection(
    loop, protocol_factory: Callable, host: str, port: int, **kwargs
):
    """``loop.create_connection`` for the sim loop: resolve (node names
    resolve deterministically, net/addr.py), connect the simulated TCP,
    adapt via SimTransport, return ``(transport, protocol)``."""
    addr = next(iter(await lookup_host((host, port))))
    stream = await TcpStream.connect(addr)
    protocol = protocol_factory()
    tr = SimTransport(loop, stream, protocol)
    tr._start()
    return tr, protocol


async def create_server(
    loop, protocol_factory: Callable, host=None, port=None, *,
    start_serving: bool = True, **kwargs
):
    """``loop.create_server`` for the sim loop."""
    listener = await TcpListener.bind((host or "0.0.0.0", port or 0))
    server = SimServer(loop, listener, protocol_factory)
    if start_serving:
        server._start()
    return server


async def create_datagram_endpoint(
    loop, protocol_factory: Callable, local_addr=None, remote_addr=None,
    **kwargs
):
    """``loop.create_datagram_endpoint`` for the sim loop."""
    sock = await UdpSocket.bind(local_addr or ("0.0.0.0", 0))
    try:
        if remote_addr is not None:
            await sock.connect(next(iter(await lookup_host(remote_addr))))
    except BaseException:
        # the bind succeeded: release the port or a retry on the same
        # local_addr fails with address-already-in-use for the rest of
        # the sim
        sock.close()
        raise
    protocol = protocol_factory()
    tr = SimDatagramTransport(
        loop, sock, protocol, sock.peer_addr
    )
    tr._start()
    return tr, protocol
