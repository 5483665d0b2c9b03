"""Shared one-connection-per-request transport for service simulators.

The reference's etcd and kafka shims both use the same pattern — each
client op opens a connection, sends one request, reads one reply
(madsim-etcd-client/src/kv.rs:25-100, madsim-rdkafka's sim clients) and
the server answers each accepted connection once. This module is that
pattern factored out so connection hygiene (half-close on the server so
the reply drains; full close on the client after reading) lives in one
place for every service built on it.
"""

from __future__ import annotations

from typing import Any, Awaitable, Callable, Type

from ..net.addr import AddrLike
from ._dual import bind_endpoint, spawn

__all__ = ["RequestClient", "ResponseStream", "StreamReply", "serve_requests"]


class StreamReply:
    """Wrap an async generator to stream a response item-per-message.

    A handler returning ``StreamReply(gen)`` keeps its connection open;
    each yielded item travels as one message until the generator ends or
    the client hangs up (the server-streaming shape of observe/watch
    style ops — the reference's tonic server-streaming analog).
    """

    __slots__ = ("gen",)

    def __init__(self, gen):
        self.gen = gen


class ResponseStream:
    """Client half of a streamed reply: ``async for`` or ``message()``."""

    def __init__(self, tx, rx, transport_error):
        self._tx = tx
        self._rx = rx
        self._err = transport_error
        self._done = False

    def __aiter__(self):
        return self

    async def __anext__(self):
        item = await self.message()
        if item is None:
            raise StopAsyncIteration
        return item

    async def message(self) -> Any | None:
        """Next item, or None when the stream ends (etcd-client shape)."""
        if self._done:
            return None
        reply = await self._rx.recv()
        if reply is None:
            self.close()
            return None
        status, payload = reply
        if status == "item":
            return payload
        self.close()
        if status == "err":
            raise payload
        return None  # "end"

    def close(self) -> None:
        """Cancel the stream; the server notices (send failure in sim,
        eof watcher on the std backend) and unwinds its generator."""
        self._done = True
        self._tx.close()
        self._rx.close()


class RequestClient:
    """Client core: ``await call(op, **kwargs)`` = one round-trip.

    ``transport_error(str) -> Exception`` wraps connection failures in
    the service's own error type.
    """

    def __init__(self, ep, dst, transport_error: Callable[[str], Exception]):
        self._ep = ep
        self._dst = dst
        self._err = transport_error

    async def close(self) -> None:
        """Release the underlying endpoint (the std backend holds real
        sockets and reader tasks; the sim endpoint a port-table entry)."""
        res = self._ep.close()
        if res is not None and hasattr(res, "__await__"):
            await res

    async def call(self, op: str, **kwargs: Any) -> Any:
        try:
            tx, rx = await self._ep.connect1(self._dst)
        except (ConnectionError, OSError) as e:
            raise self._err(str(e)) from e
        try:
            await tx.send((op, kwargs))
            reply = await rx.recv()
        except (ConnectionError, OSError) as e:
            raise self._err(str(e)) from e
        finally:
            # one request per connection: release pipes + pump tasks
            # (and the receive tag, on the std backend)
            tx.close()
            rx.close()
        if reply is None:
            raise self._err("connection reset")
        status, payload = reply
        if status == "err":
            raise payload
        return payload

    async def call_stream(self, op: str, **kwargs: Any) -> ResponseStream:
        """Open a server-streaming op; the connection stays up for the
        stream's lifetime (close the returned stream to cancel)."""
        try:
            tx, rx = await self._ep.connect1(self._dst)
            await tx.send((op, kwargs))
            first = await rx.recv()
        except (ConnectionError, OSError) as e:
            raise self._err(str(e)) from e
        if first is None:
            tx.close()
            rx.close()
            raise self._err("connection reset")
        status, payload = first
        if status == "err":
            tx.close()
            rx.close()
            raise payload
        if status != "ok-stream":
            tx.close()
            rx.close()
            raise self._err(f"expected a stream, got {status!r}")
        return ResponseStream(tx, rx, self._err)


async def serve_requests(
    addr: AddrLike,
    handler: Callable[[str, dict], Awaitable[Any]],
    error_type: Type[Exception],
    name: str = "service-request",
    on_bound: Callable[[Any], None] | None = None,
) -> None:
    """Server accept loop: each connection carries one (op, kwargs)
    request; the handler's return value (or raised ``error_type``) is
    the reply. Replies are half-closed so they drain through the pump
    before the peer sees EOF. Dual-mode: binds the sim Endpoint inside
    a simulation, the std TCP Endpoint outside.

    ``on_bound`` receives the bound local address — bind port 0 and read
    the real port from it (the flake-free pattern for test servers)."""
    ep = await bind_endpoint(addr)
    if on_bound is not None:
        on_bound(ep.local_addr)
    while True:
        tx, rx, _peer = await ep.accept1()
        spawn(_serve_one(tx, rx, handler, error_type), name=name)


async def _stream_items(tx, rx, gen, error_type) -> None:
    # cancellation watcher: the client closing its end surfaces as EOF
    # on our receive half (both backends), stopping the stream at its
    # next item instead of streaming to a closed peer forever
    cancelled = False

    async def watch():
        nonlocal cancelled
        while await rx.recv() is not None:
            pass
        cancelled = True

    watcher = spawn(watch(), name="stream-cancel-watch")
    try:
        async for item in gen:
            if cancelled:
                return
            await tx.send(("item", item))
        await tx.send(("end", None))
    finally:
        watcher.cancel()
        try:
            await gen.aclose()
        except RuntimeError:
            # task teardown delivered GeneratorExit while the generator
            # was suspended under this very frame; it is already unwinding
            pass


async def _serve_one(tx, rx, handler, error_type) -> None:
    try:
        req = await rx.recv()
        if req is None:
            return
        op, kwargs = req
        try:
            result = await handler(op, kwargs)
            if isinstance(result, StreamReply):
                await tx.send(("ok-stream", None))
                await _stream_items(tx, rx, result.gen, error_type)
            else:
                await tx.send(("ok", result))
        except error_type as e:
            try:
                await tx.send(("err", e))
            except ConnectionError:
                pass
        except ConnectionError:
            pass  # client hung up mid-stream: normal cancellation
    finally:
        tx.shutdown()
