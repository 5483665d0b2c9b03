"""ctypes wrapper for the native C++ epoll transport (native/transport.cpp).

``NativeEndpoint`` exposes the same tag-matching surface as the asyncio
backend (std/net.py) on the C++ epoll transport — the native
production-path component mirroring the reference's native Endpoint over
real TCP (C26). Both speak the same wire format, so native and asyncio
endpoints interoperate on the same network (tested in
tests/test_torch_std.py).

The wrapper body lives in std/_ctypes_ep.py, shared with the shm and
io_uring transports (identical C ABI shape).
"""

from __future__ import annotations

from ._ctypes_ep import make_transport

__all__ = ["NativeEndpoint", "available", "build"]

build, _load, NativeEndpoint = make_transport(
    "msep_", "transport.cpp", "libmstransport.so", "native"
)
NativeEndpoint.__name__ = "NativeEndpoint"


def available() -> bool:
    try:
        build()
        return True
    except Exception:
        return False
