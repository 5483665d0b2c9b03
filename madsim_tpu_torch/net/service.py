"""Service decorator: declarative RPC services over Endpoint.

Parity with the reference's ``#[madsim::service]`` + ``#[rpc]`` codegen
(madsim-macros/src/service.rs:61-110): decorate a class with
:func:`service` and its ``@rpc`` methods become typed RPC handlers; the
generated ``serve(addr)`` / ``serve_on(ep)`` methods register every
handler on an Endpoint, exactly like the generated ``serve`` functions.

    @service
    class KvStore:
        @rpc
        async def get(self, req: GetReq) -> bytes: ...

    node.spawn(KvStore().serve("0.0.0.0:7000"))

The request type is taken from the handler's single-argument annotation
(the analog of the reference's typed fn signature).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable

from .endpoint import Endpoint

__all__ = ["service", "rpc"]


def rpc(fn: Callable) -> Callable:
    """Mark a method as an RPC handler (the ``#[rpc]`` attribute)."""
    fn.__rpc_method__ = True  # type: ignore[attr-defined]
    return fn


def _request_type(fn: Callable) -> type:
    # eval_str resolves PEP-563 string annotations (modules using
    # `from __future__ import annotations`) to the actual classes
    try:
        sig = inspect.signature(fn, eval_str=True)
    except NameError as e:
        raise TypeError(
            f"@rpc method {fn.__name__}: request annotation could not be "
            f"resolved ({e}); define the request type at module scope"
        ) from e
    params = [p for name, p in sig.parameters.items() if name != "self"]
    if not params or params[0].annotation is inspect.Parameter.empty:
        raise TypeError(
            f"@rpc method {fn.__name__} must annotate its request parameter "
            f"with the request type (e.g. `async def get(self, req: GetReq)`)"
        )
    req_type = params[0].annotation
    if not isinstance(req_type, type):
        raise TypeError(
            f"@rpc method {fn.__name__}: request annotation {req_type!r} is "
            f"not a class"
        )
    return req_type


def service(cls: type) -> type:
    """Class decorator generating ``serve``/``serve_on``
    (service.rs:61-110)."""
    handlers: list[tuple[type, str]] = []
    for name, fn in inspect.getmembers(cls, inspect.isfunction):
        if getattr(fn, "__rpc_method__", False):
            handlers.append((_request_type(fn), name))
    if not handlers:
        raise TypeError(f"@service class {cls.__name__} has no @rpc methods")

    async def serve_on(self, ep: Endpoint) -> None:
        """Register every @rpc handler on an existing endpoint."""
        for req_type, name in handlers:
            bound = getattr(self, name)
            ep.add_rpc_handler(req_type, bound)

    async def serve(self, addr: Any) -> Endpoint:
        """Bind an endpoint on ``addr`` and serve all @rpc methods."""
        ep = await Endpoint.bind(addr)
        await serve_on(self, ep)
        return ep

    cls.serve = serve  # type: ignore[attr-defined]
    cls.serve_on = serve_on  # type: ignore[attr-defined]
    cls.__rpc_handlers__ = tuple(handlers)  # type: ignore[attr-defined]
    return cls
