"""Real-network Endpoint: tag-matching messaging over asyncio TCP.

Parity with reference madsim/src/std/net/tcp.rs (C26):
  * ``Endpoint`` bound on a real TCP listener (tcp.rs:22-66)
  * lazy per-peer connections: the first send dials the peer and opens
    with an address-exchange handshake so the receiver can map the
    inbound connection to the sender's canonical (listening) address for
    replies (tcp.rs:70-135)
  * length-delimited frames (the reference's LengthDelimitedCodec):
    8-byte big-endian payload length | 8-byte big-endian tag | payload
    (pickled); the handshake uses tag 2^64-1 with an ASCII "ip:port"
    payload. The native C++ transport (native/transport.cpp) speaks the
    identical format, so asyncio and native endpoints interoperate
  * the same tag-matching mailbox semantics as the simulated Endpoint
    (sim/net/endpoint.rs:288-353), so application code moves between
    the two unchanged
  * typed RPC mirroring std/net/rpc.rs: pickled requests (their bincode
    analog), random response tags, handler loops

The API is intentionally identical to madsim_tpu_torch.net.Endpoint's tag
surface: bind / send_to / recv_from / call / add_rpc_handler.
"""

from __future__ import annotations

import asyncio
import pickle
import random
import struct
from collections import deque
from typing import Any, Awaitable, Callable, Optional

from ..net.rpc import rpc_id

__all__ = ["Endpoint", "StdPipeSender", "StdPipeReceiver"]

_HEAD = struct.Struct(">QQ")  # payload length, tag
_HELLO_TAG = (1 << 64) - 1
_CONN_TAG = (1 << 64) - 2  # connection setup ("syn") messages

# asyncio streams default to a 64 KiB buffer limit; readexactly() of a
# larger frame then ping-pongs transport pause/resume every 64 KiB,
# which halved throughput at the 1 MiB bench size. 16 MiB keeps the
# reader ahead of the largest bench frame with room to spare.
_STREAM_LIMIT = 16 * 1024 * 1024

Addr = tuple[str, int]


def _parse(addr) -> Addr:
    if isinstance(addr, tuple):
        return (addr[0], int(addr[1]))
    host, port = str(addr).rsplit(":", 1)
    return (host, int(port))


class _Mailbox:
    """Tag-matching mailbox on asyncio futures (mirror of the sim's)."""

    def __init__(self) -> None:
        self.msgs: dict[int, deque] = {}
        self.waiters: dict[int, deque] = {}

    def deliver(self, tag: int, payload: Any, src: Addr) -> None:
        q = self.waiters.get(tag)
        while q:
            w = q.popleft()
            if not q:
                del self.waiters[tag]
            if not w.done():
                w.set_result((payload, src))
                return
        self.msgs.setdefault(tag, deque()).append((payload, src))

    def recv(self, tag: int) -> asyncio.Future:
        fut = asyncio.get_event_loop().create_future()
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
        self.waiters.pop(tag, None)
        self.msgs.pop(tag, None)


class Endpoint:
    """``ep = await Endpoint.bind("0.0.0.0:5000")`` on the real network."""

    def __init__(self) -> None:
        self._server: Optional[asyncio.base_events.Server] = None
        self._addr: Addr = ("0.0.0.0", 0)
        self._mailbox = _Mailbox()
        self._peers: dict[Addr, asyncio.StreamWriter] = {}
        self._peer_locks: dict[Addr, asyncio.Lock] = {}
        self._reader_tasks: set = set()
        self._closed = False

    # ---- construction ---------------------------------------------------
    @classmethod
    async def bind(cls, addr) -> "Endpoint":
        host, port = _parse(addr)
        ep = cls()
        ep._server = await asyncio.start_server(
            ep._on_accept, host, port, limit=_STREAM_LIMIT
        )
        sock = ep._server.sockets[0]
        ep._addr = sock.getsockname()[:2]
        return ep

    @property
    def local_addr(self) -> Addr:
        return self._addr

    async def close(self) -> None:
        self._closed = True
        if self._server is not None:
            self._server.close()
        # cancel readers and close writers FIRST: py3.12 wait_closed()
        # blocks until every connection handler is done
        for t in list(self._reader_tasks):
            t.cancel()
        for w in list(self._peers.values()):
            w.close()
        self._peers.clear()
        if self._reader_tasks:
            await asyncio.gather(*self._reader_tasks, return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()

    # ---- framing --------------------------------------------------------
    @staticmethod
    def _frame(tag: int, raw: bytes) -> bytes:
        return _HEAD.pack(len(raw), tag) + raw

    @staticmethod
    async def _read_frame(reader: asyncio.StreamReader) -> tuple[int, bytes]:
        head = await reader.readexactly(_HEAD.size)
        n, tag = _HEAD.unpack(head)
        raw = await reader.readexactly(n)
        return tag, raw

    # ---- connections ----------------------------------------------------
    async def _on_accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        # register ourselves so close() can cancel pre-handshake
        # connections too (py3.12 wait_closed blocks on open handlers)
        me = asyncio.current_task()
        if me is not None:
            self._reader_tasks.add(me)
            me.add_done_callback(self._reader_tasks.discard)
        # inbound handshake: the peer announces its canonical listen addr
        # (the address-exchange of tcp.rs:70-135)
        try:
            tag, raw = await self._read_frame(reader)
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            writer.close()
            return
        if tag != _HELLO_TAG:
            writer.close()
            return
        host, _, port = raw.decode().rpartition(":")
        peer_addr = (host, int(port))
        self._peers.setdefault(peer_addr, writer)
        task = asyncio.get_event_loop().create_task(
            self._read_loop(reader, writer, peer_addr)
        )
        self._reader_tasks.add(task)
        task.add_done_callback(self._reader_tasks.discard)

    async def _read_loop(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, peer: Addr
    ) -> None:
        try:
            while True:
                tag, raw = await self._read_frame(reader)
                if tag == _HELLO_TAG:
                    continue
                self._mailbox.deliver(tag, pickle.loads(raw), peer)
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            writer.close()
            if self._peers.get(peer) is writer:
                del self._peers[peer]

    async def _writer_for(self, dst: Addr) -> asyncio.StreamWriter:
        lock = self._peer_locks.setdefault(dst, asyncio.Lock())
        async with lock:
            w = self._peers.get(dst)
            if w is not None and not w.is_closing():
                return w
            reader, writer = await asyncio.open_connection(
                dst[0], dst[1], limit=_STREAM_LIMIT
            )
            # announce a routable canonical address: a wildcard bind
            # (0.0.0.0) is meaningless to the peer, so substitute the
            # outgoing socket's local IP with our listening port
            host, port = self._addr
            if host in ("0.0.0.0", "::"):
                host = writer.get_extra_info("sockname")[0]
            writer.write(self._frame(_HELLO_TAG, f"{host}:{port}".encode()))
            await writer.drain()
            self._peers[dst] = writer
            task = asyncio.get_event_loop().create_task(
                self._read_loop(reader, writer, dst)
            )
            self._reader_tasks.add(task)
            task.add_done_callback(self._reader_tasks.discard)
            return writer

    # ---- connections (sim Endpoint connect1/accept1 parity) --------------
    async def connect1(self, dst) -> tuple["StdPipeSender", "StdPipeReceiver"]:
        """Open a reliable ordered duplex "connection" to a peer endpoint
        over the real network — the std mirror of the sim Endpoint's
        ``connect1`` (sim/net/endpoint.rs:176-209), so service clients
        written against the sim surface run on real TCP unchanged.

        The connection is a pair of direction tags multiplexed over this
        endpoint's TCP link; items ride as ("d", obj) with an ("eof",)
        sentinel for half-close. Unreachable peers fail fast (the TCP
        dial happens here)."""
        dst_a = _parse(dst)
        c2s = random.getrandbits(61) | (1 << 62)  # top bit clear: no clash
        s2c = c2s | (1 << 61)                     # with RPC response tags
        host, port = self._addr
        try:
            await self._send_tagged(dst_a, _CONN_TAG, ("syn", c2s, s2c, (host, port)))
        except OSError as e:
            raise ConnectionRefusedError(f"connect to {dst_a} failed: {e}") from e
        return (
            StdPipeSender(self, dst_a, c2s),
            StdPipeReceiver(self, s2c),
        )

    async def accept1(self) -> tuple["StdPipeSender", "StdPipeReceiver", Addr]:
        """Accept one connection (sim ``accept1`` mirror): returns
        (sender, receiver, peer_addr)."""
        (kind, c2s, s2c, reply_addr), src = await self._mailbox.recv(_CONN_TAG)
        assert kind == "syn"
        peer = (src[0], reply_addr[1]) if reply_addr[0] in ("0.0.0.0", "::") else tuple(reply_addr)
        return StdPipeSender(self, peer, s2c), StdPipeReceiver(self, c2s), peer

    # ---- tag-matching datagram surface ----------------------------------
    async def send_to(self, dst, tag: int, payload: Any) -> None:
        if tag >= _CONN_TAG or tag < 0:
            raise ValueError("the top two tag values are reserved")
        await self._send_tagged(_parse(dst), tag, payload)

    async def _send_tagged(self, dst: Addr, tag: int, payload: Any) -> None:
        writer = await self._writer_for(dst)
        raw = pickle.dumps(payload)
        # two writes, no head+raw concatenation: the asyncio transport
        # chains buffers, and skipping the join saves a full copy of
        # every large payload
        writer.write(_HEAD.pack(len(raw), tag))
        writer.write(raw)
        await writer.drain()

    async def recv_from(self, tag: int) -> tuple[Any, Addr]:
        return await self._mailbox.recv(tag)

    # ---- typed RPC (std/net/rpc.rs parity) -------------------------------
    async def call(self, dst, req: Any, timeout: Optional[float] = None) -> Any:
        resp, _ = await self.call_with_data(dst, req, b"", timeout=timeout)
        return resp

    async def call_with_data(
        self, dst, req: Any, data: bytes, timeout: Optional[float] = None
    ) -> tuple[Any, bytes]:
        resp_tag = random.getrandbits(63) | (1 << 63)
        while resp_tag == _HELLO_TAG:  # 2^64-1 is reserved for the handshake
            resp_tag = random.getrandbits(63) | (1 << 63)
        await self.send_to(dst, rpc_id(type(req)), (req, data, resp_tag))
        try:
            if timeout is not None:
                payload, _src = await asyncio.wait_for(
                    self._mailbox.recv(resp_tag), timeout
                )
            else:
                payload, _src = await self._mailbox.recv(resp_tag)
        except BaseException:
            self._mailbox.drop_tag(resp_tag)
            raise
        resp, resp_data = payload
        if isinstance(resp, BaseException):
            raise resp
        return resp, resp_data

    def add_rpc_handler(
        self, req_type: type, handler: Callable[[Any], Awaitable[Any]]
    ) -> None:
        async def with_data(req: Any, _data: bytes) -> tuple[Any, bytes]:
            return await handler(req), b""

        self.add_rpc_handler_with_data(req_type, with_data)

    def add_rpc_handler_with_data(
        self,
        req_type: type,
        handler: Callable[[Any, bytes], Awaitable[tuple[Any, bytes]]],
    ) -> None:
        tag = rpc_id(req_type)
        loop = asyncio.get_event_loop()

        async def serve_loop():
            while True:
                (req, data, resp_tag), src = await self._mailbox.recv(tag)

                async def handle(req=req, data=data, resp_tag=resp_tag, src=src):
                    try:
                        resp, resp_data = await handler(req, data)
                    except Exception as exc:  # noqa: BLE001 - travels back
                        resp, resp_data = exc, b""
                    await self.send_to(src, resp_tag, (resp, resp_data))

                # hold a strong ref: the loop only weakly references
                # tasks and a mid-flight handler could be GC'd
                t = loop.create_task(handle())
                self._reader_tasks.add(t)
                t.add_done_callback(self._reader_tasks.discard)

        task = loop.create_task(serve_loop())
        self._reader_tasks.add(task)
        task.add_done_callback(self._reader_tasks.discard)


class StdPipeSender:
    """Sending half of a std connection — duck-types the sim
    ``PipeSender`` (send / shutdown / close / is_closed) so code written
    against sim connections runs on the real network."""

    __slots__ = ("_ep", "_dst", "_tag", "_closed")

    def __init__(self, ep: Endpoint, dst: Addr, tag: int):
        self._ep = ep
        self._dst = dst
        self._tag = tag
        self._closed = False

    async def send(self, payload: Any) -> None:
        if self._closed:
            raise ConnectionResetError("connection closed")
        await self._ep._send_tagged(self._dst, self._tag, ("d", payload))

    def is_closed(self) -> bool:
        return self._closed

    def _send_eof(self) -> None:
        if self._closed:
            return
        self._closed = True
        loop = asyncio.get_event_loop()
        t = loop.create_task(self._ep._send_tagged(self._dst, self._tag, ("eof",)))
        self._ep._reader_tasks.add(t)
        t.add_done_callback(self._ep._reader_tasks.discard)

    def shutdown(self) -> None:
        """Half-close: the peer reads EOF after in-flight items."""
        self._send_eof()

    def close(self) -> None:
        """Close the write direction (the receiver half is closed by its
        own ``close``; unlike the sim there is no shared group object)."""
        self._send_eof()


class StdPipeReceiver:
    """Receiving half of a std connection; ``recv`` returns None on EOF."""

    __slots__ = ("_ep", "_tag", "_eof")

    def __init__(self, ep: Endpoint, tag: int):
        self._ep = ep
        self._tag = tag
        self._eof = False

    async def recv(self) -> Any | None:
        if self._eof:
            return None
        item, _src = await self._ep._mailbox.recv(self._tag)
        if item[0] == "eof":
            self._eof = True
            self._ep._mailbox.drop_tag(self._tag)
            return None
        return item[1]

    def close(self) -> None:
        self._eof = True
        self._ep._mailbox.drop_tag(self._tag)
