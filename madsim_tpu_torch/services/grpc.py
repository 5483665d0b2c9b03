"""gRPC-style typed services over the simulated network.

Parity with the reference's madsim-tonic (madsim-tonic/src/):
  * ``Server``/``Router`` builder that accepts connections and routes on
    the request path "/package.Service/Method"
    (transport/server.rs:24-260)
  * ``Channel`` obtained from ``Endpoint.connect`` with a handshake that
    fails fast on unreachable addresses (transport/channel.rs:50-64)
  * the four call shapes: unary, client-streaming, server-streaming,
    bidirectional (client.rs:29-124)
  * ``Streaming`` response iterator (codec.rs:13-48)
  * ``Status``/``Code`` errors; a killed server surfaces as
    ``UNAVAILABLE`` at the client, the semantics the reference's
    server_crash test asserts (tonic-example/src/server.rs:371-405)

Messages travel as plain Python objects over Endpoint connections — the
analog of the reference's ``BoxMessage = Box<dyn Any>`` zero-copy payloads
(sim.rs:27-29): no serialization inside the simulation.

Instead of protoc codegen (madsim-tonic-build), services are plain Python
classes: public async methods become RPC methods; routing keys are
"/ClassName/method". The :func:`service_client` factory plays the role of
the generated client stub.

Cross-refs are to the reference's files; behavior matched, code new.
"""

from __future__ import annotations

import enum
import inspect
from typing import Any, Callable, Optional

from ..net.addr import AddrLike, SocketAddr, parse_addr
from ..runtime.future import SimFuture
from ..sync import ChannelClosed
from ._dual import bind_endpoint, in_sim, spawn

__all__ = [
    "Code",
    "Status",
    "Request",
    "Response",
    "Streaming",
    "Server",
    "Router",
    "Channel",
    "connect",
    "service_client",
]


class Code(enum.IntEnum):
    """gRPC status codes (the subset the simulator produces)."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class Status(Exception):
    """RPC error status (the reuse of real tonic::Status, sim.rs:2-4)."""

    def __init__(self, code: Code, message: str = ""):
        super().__init__(f"{code.name}: {message}")
        self.code = code
        self.message = message

    # constructors mirroring tonic::Status::*
    @classmethod
    def unavailable(cls, msg: str = "") -> "Status":
        return cls(Code.UNAVAILABLE, msg)

    @classmethod
    def not_found(cls, msg: str = "") -> "Status":
        return cls(Code.NOT_FOUND, msg)

    @classmethod
    def unimplemented(cls, msg: str = "") -> "Status":
        return cls(Code.UNIMPLEMENTED, msg)

    @classmethod
    def internal(cls, msg: str = "") -> "Status":
        return cls(Code.INTERNAL, msg)

    @classmethod
    def deadline_exceeded(cls, msg: str = "") -> "Status":
        return cls(Code.DEADLINE_EXCEEDED, msg)

    @classmethod
    def cancelled(cls, msg: str = "") -> "Status":
        return cls(Code.CANCELLED, msg)


class Request:
    """Request wrapper carrying the message and the caller's address
    (the remote_addr extension of sim.rs:35-42)."""

    __slots__ = ("message", "remote_addr", "metadata")

    def __init__(self, message: Any, remote_addr: Optional[SocketAddr] = None,
                 metadata: Optional[dict] = None):
        self.message = message
        self.remote_addr = remote_addr
        self.metadata = metadata or {}

    def into_inner(self) -> Any:
        return self.message


class Response:
    __slots__ = ("message", "metadata")

    def __init__(self, message: Any, metadata: Optional[dict] = None):
        self.message = message
        self.metadata = metadata or {}

    def into_inner(self) -> Any:
        return self.message


# wire markers (one connection per call, like Grpc::unary/streaming,
# client.rs:29-124)
_MSG = "msg"  # ("msg", payload)
_END = "end"  # ("end",)
_ERR = "err"  # ("err", Status)


class Streaming:
    """Async iterator over a stream of response (or request) messages
    (codec.rs:13-48). Ends on the end marker; raises Status on error;
    a dropped/reset peer surfaces UNAVAILABLE."""

    def __init__(self, rx, own_connection: bool = True):
        self._rx = rx
        self._done = False
        # server-side request streams must not close the connection when
        # the request stream ends — the reply still travels back over it
        self._own = own_connection

    def __aiter__(self) -> "Streaming":
        return self

    async def __anext__(self) -> Any:
        if self._done:
            raise StopAsyncIteration
        try:
            item = await self._rx.recv()
        except (ChannelClosed, EOFError, ConnectionError):
            self._finish()
            raise Status.unavailable("connection reset by peer") from None
        if item is None:
            self._finish()
            raise Status.unavailable("connection reset by peer")
        kind = item[0]
        if kind == _MSG:
            return item[1]
        if kind == _END:
            self._finish()
            raise StopAsyncIteration
        self._finish()
        raise item[1]

    def _finish(self) -> None:
        """Stream over: release the per-call connection (both directions)
        so calls don't accumulate pipes/pump tasks."""
        self._done = True
        if self._own:
            self._rx.close()

    async def message(self) -> Optional[Any]:
        """tonic-style: next message or None at end of stream."""
        try:
            return await self.__anext__()
        except StopAsyncIteration:
            return None


def _route_key(service_name: str, method: str) -> str:
    return f"/{service_name}/{method}"


def _classify(func: Callable, owner: Optional[type] = None) -> str:
    """unary | client_stream | server_stream | bidi.

    Explicit ``__rpc_shape__`` markers win (set by the .proto codegen,
    grpc_codegen.py — checked through the owner's MRO so user overrides
    of generated servicer methods keep the declared shape); otherwise
    classify by signature: an async-generator handler streams responses,
    and a handler whose single argument is annotated/named as a stream
    consumes a request stream."""
    marked = getattr(func, "__rpc_shape__", None)
    if marked is not None:
        return marked
    if owner is not None:
        name = getattr(func, "__name__", None)
        for klass in getattr(owner, "__mro__", ()):
            base = klass.__dict__.get(name)
            if base is not None and getattr(base, "__rpc_shape__", None):
                return base.__rpc_shape__
    wants_stream = False
    params = [
        p
        for p in inspect.signature(func).parameters.values()
        if p.name not in ("self",)
    ]
    if params:
        p0 = params[0]
        ann = str(p0.annotation).lower()
        wants_stream = "streaming" in ann or p0.name in ("stream", "requests")
    produces_stream = inspect.isasyncgenfunction(func)
    if produces_stream:
        return "bidi" if wants_stream else "server_stream"
    return "client_stream" if wants_stream else "unary"


class Router:
    """Accumulated services + the accept loop
    (transport/server.rs:156-260)."""

    local_addr = None  # set once serving (bind port 0, read it here)

    def __init__(self) -> None:
        self._services: dict[str, Any] = {}

    def add_service(self, svc: Any, name: Optional[str] = None) -> "Router":
        svc_name = name or getattr(svc, "SERVICE_NAME", type(svc).__name__)
        self._services[svc_name] = svc
        return self

    async def serve(self, addr: AddrLike) -> None:
        await self.serve_with_shutdown(addr, None)

    async def serve_with_shutdown(
        self, addr: AddrLike, signal: Optional[SimFuture]
    ) -> None:
        """Bind and accept until ``signal`` resolves (server.rs:202-260).
        Each accepted connection carries exactly one call."""
        ep = await bind_endpoint(addr)
        # bind port 0 and read the real port from here (test de-flaking)
        self.local_addr = ep.local_addr
        loop = spawn(self._accept_loop(ep), name="grpc-accept-loop")
        if signal is None:
            await loop
            return
        if in_sim():
            from ..runtime.future import select

            idx, _ = await select(loop._handle._fut, signal)
            if idx == 1:
                loop.cancel()
        else:
            import asyncio as _aio

            sig = _aio.ensure_future(signal)
            done, _pending = await _aio.wait(
                [loop, sig], return_when=_aio.FIRST_COMPLETED
            )
            if sig in done:
                loop.cancel()

    async def _accept_loop(self, ep) -> None:
        while True:
            tx, rx, peer = await ep.accept1()
            spawn(self._serve_conn(tx, rx, peer), name="grpc-conn")

    async def _serve_conn(self, tx, rx, peer) -> None:
        try:
            first = await rx.recv()
        except (ChannelClosed, EOFError, ConnectionError):
            return
        if first is None or first[0] != "call":
            return
        _, path, payload = first
        try:
            _, svc_name, method_name = path.split("/")
            svc = self._services[svc_name]
            func = getattr(svc, method_name)
            if method_name.startswith("_") or not callable(func):
                raise KeyError(method_name)
            shape = _classify(func, owner=type(svc))
        except (ValueError, KeyError, AttributeError, TypeError):
            try:
                await tx.send((_ERR, Status.unimplemented(f"unknown path {path}")))
            except (ChannelClosed, ConnectionError):
                pass
            finally:
                tx.shutdown()
            return

        try:
            if shape == "unary":
                resp = await func(Request(payload, peer))
                await tx.send((_MSG, _unwrap(resp)))
                await tx.send((_END,))
            elif shape == "client_stream":
                resp = await func(Streaming(rx, own_connection=False))
                await tx.send((_MSG, _unwrap(resp)))
                await tx.send((_END,))
            elif shape == "server_stream":
                async for item in func(Request(payload, peer)):
                    await tx.send((_MSG, _unwrap(item)))
                await tx.send((_END,))
            else:  # bidi
                async for item in func(Streaming(rx, own_connection=False)):
                    await tx.send((_MSG, _unwrap(item)))
                await tx.send((_END,))
        except Status as status:
            try:
                await tx.send((_ERR, status))
            except (ChannelClosed, ConnectionError):
                pass
        except (ChannelClosed, EOFError, ConnectionError):
            # peer went away mid-call (client crash/drop): nothing to do —
            # the reference's client_crash test relies on the server
            # surviving this (tonic-example/src/server.rs:283-331)
            pass
        finally:
            # one call per connection: half-close so the queued reply
            # still drains through the pump, then the client's close of
            # its receiving end releases the whole group
            tx.shutdown()


def _unwrap(resp: Any) -> Any:
    return resp.message if isinstance(resp, Response) else resp


class Server:
    """Server builder (transport/server.rs:24-152). The reference accepts
    ~15 HTTP/2 tuning knobs and ignores them all in simulation; kwargs
    are accepted and ignored here for the same drop-in reason."""

    def __init__(self, **_ignored: Any) -> None:
        self._router = Router()

    @staticmethod
    def builder(**kwargs: Any) -> "Server":
        return Server(**kwargs)

    def add_service(self, svc: Any, name: Optional[str] = None) -> Router:
        return self._router.add_service(svc, name)


class Channel:
    """A connected-on-demand client channel (transport/channel.rs:12-64).

    Connecting performs one handshake connection so unreachable
    addresses fail fast with UNAVAILABLE, then each call opens its own
    connection (client.rs:29-53 does the same per-call connect1)."""

    def __init__(self, ep, dst: SocketAddr):
        self._ep = ep
        self._dst = dst

    @classmethod
    async def connect(cls, dst: AddrLike) -> "Channel":
        ep = await bind_endpoint("0.0.0.0:0")
        dst_a = parse_addr(dst)
        try:
            tx, _rx = await ep.connect1(dst_a)
        except (ConnectionError, OSError) as e:
            raise Status.unavailable(f"failed to connect to {dst_a}: {e}") from e
        tx.close()
        return cls(ep, dst_a)

    async def close(self) -> None:
        """Release the channel's endpoint (sockets/reader tasks on the
        std backend; a port-table entry in simulation)."""
        res = self._ep.close()
        if res is not None and hasattr(res, "__await__"):
            await res

    async def _open(self):
        try:
            return await self._ep.connect1(self._dst)
        except (ConnectionError, OSError) as e:
            raise Status.unavailable(str(e)) from e

    # ---- the four call shapes (client.rs:29-124) ------------------------
    async def unary(self, path: str, msg: Any, timeout: Optional[float] = None) -> Any:
        tx, rx = await self._open()
        try:
            await tx.send(("call", path, msg))
        except (ChannelClosed, ConnectionError) as e:
            raise Status.unavailable(str(e)) from e
        stream = Streaming(rx)
        if timeout is not None:
            from ..runtime.time_ import Elapsed
            from ..runtime.time_ import timeout as timeout_

            try:
                return await timeout_(timeout, stream.__anext__())
            except Elapsed:
                # release the abandoned per-call connection, or retry
                # loops under partition leak pipes+pump tasks per attempt
                stream._finish()
                raise Status.deadline_exceeded(path) from None
        return await stream.__anext__()

    async def client_streaming(self, path: str) -> tuple["_SendHalf", "_UnaryReply"]:
        tx, rx = await self._open()
        await tx.send(("call", path, None))
        return _SendHalf(tx), _UnaryReply(Streaming(rx))

    async def server_streaming(self, path: str, msg: Any) -> Streaming:
        tx, rx = await self._open()
        await tx.send(("call", path, msg))
        return Streaming(rx)

    async def bidi(self, path: str) -> tuple["_SendHalf", Streaming]:
        tx, rx = await self._open()
        await tx.send(("call", path, None))
        return _SendHalf(tx), Streaming(rx)


class _SendHalf:
    """Client-side request stream (send_request_stream, client.rs:126-146)."""

    def __init__(self, tx):
        self._tx = tx

    async def send(self, msg: Any) -> None:
        try:
            await self._tx.send((_MSG, msg))
        except (ChannelClosed, ConnectionError) as e:
            raise Status.unavailable(str(e)) from e

    async def finish(self) -> None:
        try:
            await self._tx.send((_END,))
        except (ChannelClosed, ConnectionError):
            pass

    def drop(self) -> None:
        """Abandon the stream without finishing (the client-drops-stream
        scenario, tonic-example/src/server.rs:333-369)."""
        self._tx.close()


class _UnaryReply:
    """Awaitable single reply to a client-streaming call."""

    def __init__(self, stream: Streaming):
        self._stream = stream

    def __await__(self):
        return self._stream.__anext__().__await__()


async def connect(dst: AddrLike) -> Channel:
    """Shorthand: ``channel = await grpc.connect("10.0.0.1:50051")``."""
    return await Channel.connect(dst)


def service_client(service: type | str, channel: Channel):
    """Generated-client analog (madsim-tonic-build/src/client.rs): returns
    an object with one async method per public async method of
    ``service``, routing to "/ServiceName/method".

    unary:           await client.say_hello(msg)
    server-stream:   stream = await client.lots_of_replies(msg)
    client-stream:   tx, reply = await client.record(); await tx.send(..)
    bidi:            tx, stream = await client.chat()
    """
    if isinstance(service, str):
        raise TypeError("pass the service class so call shapes are known")
    svc_name = getattr(service, "SERVICE_NAME", service.__name__)

    class _Client:
        def __init__(self) -> None:
            self.channel = channel

    for name, func in inspect.getmembers(service, inspect.isfunction):
        if name.startswith("_"):
            continue
        # owner=service: overrides of codegen servicer methods keep the
        # declared shape on the client side too (matching the Router)
        shape = _classify(func, owner=service)
        path = _route_key(svc_name, name)

        def make(shape: str, path: str):
            if shape == "unary":

                async def call(self, msg: Any = None, timeout: Optional[float] = None):
                    return await self.channel.unary(path, msg, timeout=timeout)

            elif shape == "server_stream":

                async def call(self, msg: Any = None):
                    return await self.channel.server_streaming(path, msg)

            elif shape == "client_stream":

                async def call(self):
                    return await self.channel.client_streaming(path)

            else:

                async def call(self):
                    return await self.channel.bidi(path)

            return call

        setattr(_Client, name, make(shape, path))

    _Client.__name__ = f"{svc_name}Client"
    return _Client()
