"""Batched simulation workloads for the torch engine.

Every model family of the JAX package is ported: the six
``BENCH_SPECS`` models — ``raft`` (5-node leader election, the main
path), ``microbench``, ``pingpong``, ``broadcast``, ``kvchaos`` (with
and without the payload arena) and ``raftlog`` — and the five that the
JAX package runs in its soaks — ``snapshot``, ``twophase``, ``paxos``,
``leasekv`` and ``shardkv`` (``SOAK_SPECS``). Seven of them also record
operation histories (``record=True``), and three carry a planted fault
only the histories show (``bug=True``): ``RECORD_VARIANTS``.
"""

import functools

from .broadcast import make_broadcast  # noqa: F401
from .kvchaos import make_kvchaos  # noqa: F401
from .leasekv import make_leasekv  # noqa: F401
from .microbench import make_microbench  # noqa: F401
from .paxos import make_paxos  # noqa: F401
from .pingpong import make_pingpong  # noqa: F401
from .raft import make_raft  # noqa: F401
from .raftlog import make_raftlog  # noqa: F401
from .shardkv import make_shardkv  # noqa: F401
from .snapshot import make_snapshot  # noqa: F401
from .twophase import make_twophase  # noqa: F401

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

# The five families without a BENCH_SPECS entry, at the configurations
# the JAX package's own soaks run them, in the same tuple form: engine
# config and step cap from tools/oracle_soak.py:55-64 (snapshot,
# twophase, paxos) and tools/services_model_soak.py:65-70 (leasekv,
# shardkv); seeds from tools/check_soak.py:93 (8,192) and
# tools/services_model_soak.py:185 (4,096)
SOAK_SPECS = {
    "snapshot": (make_snapshot, dict(pool_size=96), 8192, 400),
    "twophase": (
        functools.partial(make_twophase, txns=4),
        dict(pool_size=64, loss_p=0.03), 8192, 500,
    ),
    "paxos": (make_paxos, dict(pool_size=64, loss_p=0.02), 8192, 400),
    "leasekv": (make_leasekv, dict(pool_size=48, loss_p=0.02, **_B2), 4096, 4000),
    "shardkv": (make_shardkv, dict(pool_size=64, loss_p=0.02, **_B2), 4096, 6000),
}

# The record and bug variants the run kernel carries: workload name ->
# (the BENCH_SPECS or SOAK_SPECS entry whose shape they run at, the
# factory's extra keyword arguments)
RECORD_VARIANTS = {
    "raft-election-record": ("raft", {"record": True}),
    "kvchaos-record": ("kvchaos", {"record": True}),
    "kvchaos-bug": ("kvchaos", {"record": True, "bug": True}),
    "raftlog-record": ("raftlog", {"record": True}),
    "twophase-record": ("twophase", {"record": True}),
    "paxos-record": ("paxos", {"record": True}),
    "leasekv-record": ("leasekv", {"record": True}),
    "leasekv-bug": ("leasekv", {"record": True, "bug": True}),
    "shardkv-record": ("shardkv", {"record": True}),
    "shardkv-bug": ("shardkv", {"record": True, "bug": True}),
}
