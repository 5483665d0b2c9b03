"""Batched simulation workloads for the torch engine.

Ported so far: ``raft`` (5-node leader election, the main path). The
other models of the JAX package wait for later slices (ROADMAP queue
A5 and A9).
"""

from .raft import make_raft  # noqa: F401

# The benchmark configurations of the JAX package's models/__init__.py,
# for the ported models:
#   name -> (factory, engine-config kwargs, bench seed count, step cap)
_B2 = {"clog_backoff_max_ns": 2_000_000_000}
BENCH_SPECS = {
    "raft": (make_raft, dict(pool_size=40, loss_p=0.02, **_B2), 65536, 600),
}
