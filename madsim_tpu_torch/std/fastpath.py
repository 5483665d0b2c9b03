"""Shared-memory fast-path endpoint (native/shm_transport.cpp wrapper).

The reference offers optional kernel-bypass transports behind cargo
features — UCX RDMA (madsim/src/std/net/ucx.rs:23-30, C27) and
eRPC/ibverbs (std/net/erpc.rs:24-30, C28) — exposing the same
tag-matching Endpoint API as the TCP backend. This environment has no
RDMA NIC, so that role is filled honestly for the case those transports
accelerate most: ``ShmEndpoint`` moves messages between same-host
endpoints through a POSIX shared-memory ring with no socket syscalls on
the data path, behind the exact surface of
:class:`madsim_tpu_torch.std.native.NativeEndpoint` (bind/send_to/recv_from/
close). ``pick_endpoint`` is the feature-selection seam: shm for
loopback peers, epoll TCP otherwise — the analog of the reference's
``ucx``/``erpc`` feature switch (std/net/mod.rs:33-48).

Measured on loopback (examples/rpc_bench.py): the shm path beats the
epoll transport on both empty-RPC latency and 1 MiB payload throughput.
"""

from __future__ import annotations

from typing import Optional

from ._ctypes_ep import make_transport, split_addr

__all__ = ["ShmEndpoint", "available", "build", "pick_endpoint"]

# wrapper body shared with the epoll and io_uring transports
# (std/_ctypes_ep.py — identical C ABI shape)
build, _load, ShmEndpoint = make_transport(
    "shmep_", "shm_transport.cpp", "libshmtransport.so", "shm"
)
ShmEndpoint.__name__ = "ShmEndpoint"


def available() -> bool:
    try:
        build()
        return True
    except Exception:
        return False


_split = split_addr


_LOCAL_IPS = ("127.0.0.1", "localhost", "0.0.0.0", "::1")


async def pick_endpoint(
    addr,
    *,
    prefer_shm: Optional[bool] = None,
    prefer_uring: Optional[bool] = None,
):
    """Bind the fastest transport for ``addr`` — the feature-selection
    seam of the reference's std/net/mod.rs:33-48, now with both C28
    alternative slots filled:

      1. shm ring for loopback/same-host peers (the UCX-style bypass);
      2. io_uring proactor TCP when the kernel grants a ring (the
         eRPC-style alternative; cross-host capable, same wire format);
      3. epoll TCP otherwise.

    ``prefer_shm=False`` with ``prefer_uring=None`` probes io_uring;
    set ``prefer_uring=False`` to force epoll."""
    host, _ = _split(addr)
    want_shm = prefer_shm if prefer_shm is not None else host in _LOCAL_IPS
    if want_shm and available():
        return await ShmEndpoint.bind(addr)
    from . import uring

    want_uring = prefer_uring if prefer_uring is not None else True
    if want_uring and uring.available():
        return await uring.UringEndpoint.bind(addr)
    from .native import NativeEndpoint

    return await NativeEndpoint.bind(addr)
