"""ctypes wrapper for the io_uring transport (native/uring_transport.cpp).

``UringEndpoint`` is the second alternative fast-path transport behind
``pick_endpoint`` — the C28 slot: the reference ships two alternative
kernel-adjacent transports behind one feature seam (UCX,
madsim/src/std/net/ucx.rs:23-30; eRPC, std/net/erpc.rs:24-30). Here the
alternatives are the shared-memory ring (same-host) and this io_uring
proactor endpoint (cross-host capable, same wire format as the epoll
and asyncio backends, so all four interoperate).

The wrapper body lives in std/_ctypes_ep.py, shared with the epoll and
shm transports (identical C ABI shape).
"""

from __future__ import annotations

from ._ctypes_ep import make_transport

__all__ = ["UringEndpoint", "available", "build"]

build, _load, UringEndpoint = make_transport(
    "urep_", "uring_transport.cpp", "liburingtransport.so", "io_uring"
)
UringEndpoint.__name__ = "UringEndpoint"


def available() -> bool:
    """True when the lib builds AND the kernel grants an io_uring."""
    try:
        return bool(_load().urep_available())
    except Exception:
        return False
