"""Batched simulation workloads for the torch engine.

Ported so far: the six ``BENCH_SPECS`` models of the JAX package —
``raft`` (5-node leader election, the main path), ``microbench``,
``pingpong``, ``broadcast``, ``kvchaos`` (with and without the payload
arena) and ``raftlog``. The remaining models (twophase, paxos, snapshot,
leasekv, shardkv) wait for later slices (ROADMAP queue A9).
"""

from .broadcast import make_broadcast  # noqa: F401
from .kvchaos import make_kvchaos  # noqa: F401
from .microbench import make_microbench  # noqa: F401
from .pingpong import make_pingpong  # noqa: F401
from .raft import make_raft  # noqa: F401
from .raftlog import make_raftlog  # noqa: F401

# The benchmark configurations of the JAX package's models/__init__.py:
#   name -> (factory, engine-config kwargs, bench seed count, step cap)
_B2 = {"clog_backoff_max_ns": 2_000_000_000}
BENCH_SPECS = {
    "raft": (make_raft, dict(pool_size=40, loss_p=0.02, **_B2), 65536, 600),
    "microbench": (make_microbench, dict(pool_size=32, **_B2), 1024, 1100),
    "pingpong": (make_pingpong, dict(pool_size=32, **_B2), 1, 300),
    "broadcast": (make_broadcast, dict(pool_size=40, loss_p=0.05, **_B2), 16384, 500),
    "kvchaos": (make_kvchaos, dict(pool_size=40, loss_p=0.02, **_B2), 4096, 900),
    "raftlog": (make_raftlog, dict(pool_size=64, loss_p=0.02, **_B2), 16384, 4000),
}
