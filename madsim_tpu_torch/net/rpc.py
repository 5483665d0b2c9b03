"""Typed request/response RPC over Endpoint tags.

Parity with reference madsim/src/sim/net/rpc.rs:
  * each request type has a stable 64-bit tag derived from its qualified
    name (the analog of ``#[derive(Request)]``'s
    ``ID = hash_str(module_path + name)``, madsim-macros/src/request.rs:
    60-66) — no registration or serialization needed in simulation.
  * ``call`` sends ``(req, data, resp_tag, ...)`` on the request tag with a
    *random* u64 response tag, then awaits that tag (rpc.rs:96-131).
  * ``add_rpc_handler`` spawns a service loop on the current node:
    receive -> spawn handler task -> reply (rpc.rs:134-166).
"""

from __future__ import annotations

import hashlib
from typing import Any, Awaitable, Callable, Optional

from ..runtime import context, task as task_mod
from ..runtime.time_ import timeout as time_timeout
from .addr import AddrLike

__all__ = ["rpc_id", "call", "call_with_data", "add_rpc_handler", "add_rpc_handler_with_data"]


def rpc_id(req_type: type) -> int:
    """Stable request tag from the type's qualified name (request.rs:60-66).

    Override by setting a class attribute ``__rpc_id__``."""
    explicit = req_type.__dict__.get("__rpc_id__")
    if explicit is not None:
        return int(explicit)
    name = f"{req_type.__module__}.{req_type.__qualname__}"
    # masked to 63 bits: the bit-63 tag space is reserved for response
    # frames (see call_with_data / Endpoint.send_to)
    return int.from_bytes(
        hashlib.sha256(name.encode()).digest()[:8], "big"
    ) & ((1 << 63) - 1)


async def call(ep, dst: AddrLike, req: Any, timeout: Optional[float] = None) -> Any:
    resp, _ = await call_with_data(ep, dst, req, b"", timeout=timeout)
    return resp


async def call_with_data(
    ep, dst: AddrLike, req: Any, data: bytes, timeout: Optional[float] = None
) -> tuple[Any, bytes]:
    """Send a typed request plus a data payload; await the typed response
    (rpc.rs:114-131). A response tag is drawn at random per call."""
    rng = context.current_handle().rng
    resp_tag = rng.getrandbits(63) | (1 << 63)  # avoid user tag collisions
    req_tag = rpc_id(type(req))
    await ep.send_to(dst, req_tag, (req, data, resp_tag))

    async def wait_resp():
        payload, _src = await ep.recv_from(resp_tag)
        return payload

    if timeout is not None:
        try:
            result = await time_timeout(timeout, wait_resp())
        except BaseException:
            # The per-call response tag is never reused; drop its waiter so
            # failed calls don't grow the mailbox.
            ep._mailbox.drop_tag(resp_tag)
            raise
    else:
        result = await wait_resp()
    resp, resp_data = result
    if isinstance(resp, BaseException):
        raise resp
    return resp, resp_data


def add_rpc_handler(ep, req_type: type, handler: Callable[[Any], Awaitable[Any]]) -> None:
    """Serve ``req_type`` requests on this endpoint: each request spawns a
    handler task whose return value is sent back (rpc.rs:134-150).
    Exceptions raised by the handler travel back and re-raise at the
    caller."""

    async def with_data(req: Any, _data: bytes) -> tuple[Any, bytes]:
        return await handler(req), b""

    add_rpc_handler_with_data(ep, req_type, with_data)


def add_rpc_handler_with_data(
    ep, req_type: type, handler: Callable[[Any, bytes], Awaitable[tuple[Any, bytes]]]
) -> None:
    """Data-carrying variant (rpc.rs:152-166)."""
    tag = rpc_id(req_type)

    async def serve_loop():
        while True:
            (req, data, resp_tag), src = await ep.recv_from(tag)

            async def handle(req=req, data=data, resp_tag=resp_tag, src=src):
                try:
                    resp, resp_data = await handler(req, data)
                except Exception as exc:  # noqa: BLE001 - travels to caller
                    resp, resp_data = exc, b""
                await ep.send_to(src, resp_tag, (resp, resp_data), _reserved=True)

            task_mod.spawn(handle(), name=f"rpc:{req_type.__name__}")

    task_mod.spawn(serve_loop(), name=f"rpc-serve:{req_type.__name__}")
