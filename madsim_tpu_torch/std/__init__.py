"""Real-world backends — the production path.

The reference is a drop-in library: build normally and every API runs on
real I/O; build with ``--cfg madsim`` and the same code runs simulated
(reference madsim/src/lib.rs:14-23). This package is our real side
(SURVEY.md §1 L5, C26/C29): the same Endpoint / RPC / fs / time API
surfaces backed by asyncio TCP, the real filesystem and the real clock,
so an application written against the simulator deploys unchanged:

    if os.environ.get("MADSIM"):
        from madsim_tpu_torch import net, fs
    else:
        from madsim_tpu_torch.std import net, fs

Transport details mirror C26 (std/net/tcp.rs:22-135): lazy per-peer TCP
connections with an address-exchange handshake and length-delimited
frames; payloads are pickled (the analog of the reference's bincode
serialization in std/net/rpc.rs).
"""

from . import fs, net, time  # noqa: F401
