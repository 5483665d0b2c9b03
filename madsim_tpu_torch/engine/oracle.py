"""ctypes bridge to the C++ single-seed oracle (``native/oracle.cpp``).

A copy of what replay needs from ``madsim_tpu/engine/oracle.py``. The
oracle reimplements the engine's integer semantics and the benchmark
workloads independently; :func:`run_oracle` runs one seed and returns
the fields the trace compare checks.

:func:`build` compiles ``native/oracle.cpp`` with g++ into
``build/oracle/<hash>/liboracle.so`` at the root of the checkout, keyed
by a hash of the source and the flags; it writes through a temporary
name and renames, so processes that build at once each get a whole
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .core import EngineConfig, Workload

__all__ = [
    "ORACLE_LOCK",
    "WORKLOAD_IDS",
    "OracleResult",
    "assert_plan_oracle_free",
    "build",
    "load",
    "run_oracle",
    "set_params",
]

# the oracle's parameter registers and optional event-log buffers are
# process globals (oracle.cpp g_* / g_log_*), so every set_params ->
# oracle_run window is serialised process-wide. Reentrant, so replay()
# can hold it across its attach -> run_oracle -> detach span.
ORACLE_LOCK = threading.RLock()

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "oracle.cpp"
BUILD_ROOT = _ROOT / "build" / "oracle"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

WORKLOAD_IDS = {
    "pingpong": 0,
    "microbench": 1,
    "raft-election": 2,
    "broadcast": 3,
    "kvchaos": 4,
    "kvchaos-payload": 4,  # same C++ workload; payload flag via set_params
    "twophase": 5,
    "raftlog": 6,
    "paxos": 7,
    "snapshot": 8,
}

_lib = None


def build() -> Path:
    """Build (once per source hash) and return the shared library path."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    lib = BUILD_ROOT / h.hexdigest()[:16] / "liboracle.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"liboracle.{os.getpid()}.so")
    done = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if done.returncode != 0:
        raise RuntimeError(f"g++ failed building the oracle:\n{done.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.oracle_run.restype = ctypes.c_int32
        lib.oracle_run.argtypes = [
            ctypes.c_int32, ctypes.c_uint64, ctypes.c_int64,  # wl, seed, steps
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # pool, lat lo/hi
            ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,  # loss, proc lo/hi
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # backoff lo/hi, limit
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
    return _lib


@dataclass
class OracleResult:
    now: int
    trace: int
    msg_count: int
    halted: bool
    halt_time: int
    overflow: int
    node_state: np.ndarray  # (N, U) int32


def set_params(lib: ctypes.CDLL, wl: Workload, **model_kwargs) -> None:
    """Push the model factory's parameters into the oracle's compiled
    workload: the workload's own ``model_params``, then ``model_kwargs``
    over them."""
    kw = {**dict(wl.model_params), **model_kwargs}
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    flag = lambda name, default: i32(1 if kw.get(name, default) else 0)  # noqa: E731
    if wl.name == "pingpong":
        lib.oracle_set_pingpong(i32(kw["rounds"]), i32(kw.get("n_clients", 2)))
    elif wl.name == "microbench":
        lib.oracle_set_microbench(
            i32(kw["rounds"]),
            i64(kw.get("delay_min_ns", 1_000)),
            i64(kw.get("delay_max_ns", 1_000_000)),
        )
    elif wl.name == "raft-election":
        lib.oracle_set_raft(
            i32(kw.get("n_nodes", 5)),
            i64(kw.get("timeout_min_ns", 150_000_000)),
            i64(kw.get("timeout_max_ns", 300_000_000)),
        )
    elif wl.name == "broadcast":
        lib.oracle_set_broadcast(
            i32(kw.get("rounds", 5)),
            i32(kw.get("n_nodes", 5)),
            i64(kw.get("retx_ns", 50_000_000)),
            flag("partition", True),
        )
    elif wl.name == "twophase":
        lib.oracle_set_twophase(
            i32(kw.get("txns", 5)),
            i32(kw.get("n_parts", 4)),
            i32(kw.get("no_pct", 10)),
            i64(kw.get("retx_ns", 40_000_000)),
            flag("chaos", True),
            i64(kw.get("revive_min_ns", 80_000_000)),
            i64(kw.get("revive_max_ns", 400_000_000)),
        )
    elif wl.name in ("kvchaos", "kvchaos-payload"):
        lib.oracle_set_kvchaos(
            i32(kw.get("writes", 20)),
            i32(kw.get("n_replicas", 4)),
            i64(kw.get("retx_ns", 40_000_000)),
            i64(kw.get("client_retx_ns", 100_000_000)),
            flag("chaos", True),
            i32(1 if wl.payload_words else 0),
        )
    elif wl.name == "raftlog":
        rc = lib.oracle_set_raftlog(
            i32(kw.get("n_nodes", 5)),
            i32(kw.get("n_writes", 4)),
            i64(kw.get("timeout_min_ns", 150_000_000)),
            i64(kw.get("timeout_max_ns", 300_000_000)),
            i64(kw.get("propose_ns", 20_000_000)),
            i64(kw.get("retx_ns", 60_000_000)),
            flag("chaos", True),
        )
        if rc:
            raise ValueError("oracle payload arena caps n_writes at 4")
    elif wl.name == "paxos":
        lib.oracle_set_paxos(
            i32(kw.get("n_acceptors", 5)),
            i32(kw.get("n_proposers", 3)),
            i64(kw.get("start_min_ns", 5_000_000)),
            i64(kw.get("start_max_ns", 30_000_000)),
            i64(kw.get("timeout_min_ns", 60_000_000)),
            i64(kw.get("timeout_max_ns", 120_000_000)),
            flag("chaos", True),
            i64(kw.get("kill_min_ns", 30_000_000)),
            i64(kw.get("kill_max_ns", 150_000_000)),
            i64(kw.get("revive_min_ns", 80_000_000)),
            i64(kw.get("revive_max_ns", 300_000_000)),
            flag("durable_acceptors", False),
        )
    elif wl.name == "snapshot":
        lib.oracle_set_snapshot(
            i32(kw.get("n_nodes", 5)),
            i32(kw.get("n_sends", 6)),
            i32(kw.get("balance", 1000)),
            i32(kw.get("amount_max", 100)),
            i64(kw.get("send_min_ns", 5_000_000)),
            i64(kw.get("send_max_ns", 25_000_000)),
            i64(kw.get("snap_min_ns", 20_000_000)),
            i64(kw.get("snap_max_ns", 80_000_000)),
        )
    else:
        raise ValueError(f"oracle has no implementation of workload {wl.name!r}")


def _plan_kinds(plan) -> set:
    """The kinds a fault plan can inject (a FaultPlan's slot templates,
    a LiteralPlan's events)."""
    if hasattr(plan, "slot_templates"):
        return {int(t.kind) for t in plan.slot_templates()}
    if hasattr(plan, "events"):
        return {int(e.kind) for e in plan.events}
    raise TypeError(f"not a chaos plan: {type(plan).__name__}")


def assert_plan_oracle_free(plan) -> None:
    """Refuse an oracle compare against a plan-driven run: the oracle has
    no plan channel (plans are pre-seeded pool rows) and none of the
    extended chaos kinds. Plan-driven runs are held against the JAX
    engine and the plain step instead."""
    from .core import FIRST_EXT_KIND

    ext = sorted(k for k in _plan_kinds(plan) if k >= FIRST_EXT_KIND)
    if ext:
        raise ValueError(
            f"the C++ oracle does not implement extended chaos kinds "
            f"{ext} (engine kinds >= {FIRST_EXT_KIND}: slow-link/dup/"
            f"skew/one-way-clog and the SYNC_LOSS/TORN disk faults); "
            f"plan-driven runs are verified by the two-run/two-layout "
            f"compare instead (engine.verify.check_layouts / "
            f"compare_traces)"
        )
    raise ValueError(
        "the C++ oracle takes no fault plan (plans are pre-seeded "
        "engine pool rows, a channel the oracle does not have); verify "
        "plan-driven runs with the two-run/two-layout compare instead "
        "(engine.verify.check_layouts / compare_traces)"
    )


def run_oracle(
    wl: Workload, cfg: EngineConfig, seed: int, n_steps: int, plan=None,
    **model_kwargs,
) -> OracleResult:
    """Run one seed through the C++ oracle. ``model_kwargs`` override
    the workload's ``model_params``. ``plan`` only raises: the oracle
    cannot run a fault plan (:func:`assert_plan_oracle_free`). A
    sync-discipline workload (``Workload.durable_sync``) compares as
    long as it syncs every durable write in the dispatch that made it:
    its trajectory is then the verbatim-durable one the oracle runs
    (raftlog ``durable=True``)."""
    if plan is not None:
        assert_plan_oracle_free(plan)
    lib = load()
    with ORACLE_LOCK:
        return _run_locked(lib, wl, cfg, seed, n_steps, **model_kwargs)


def _run_locked(
    lib, wl: Workload, cfg: EngineConfig, seed: int, n_steps: int, **model_kwargs
) -> OracleResult:
    set_params(lib, wl, **model_kwargs)
    # the workload's initial rows, so that a nonzero init_state (and the
    # restart that restores it) stays bit-identical
    init_rows = np.ascontiguousarray(wl.initial_state(), dtype=np.int32)
    lib.oracle_set_init_state(
        init_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(init_rows.size),
    )
    # durable (restart-surviving) columns, always pushed, so a prior
    # run's setting cannot leak into a workload without any
    dur = np.asarray(sorted(wl.durable_cols or ()), dtype=np.int32)
    lib.oracle_set_durable_cols(
        dur.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) if dur.size else None,
        ctypes.c_int64(dur.size),
    )
    now = ctypes.c_int64()
    trace = ctypes.c_uint64()
    msg_count = ctypes.c_int64()
    halted = ctypes.c_int32()
    halt_time = ctypes.c_int64()
    overflow = ctypes.c_int32()
    node_state = np.zeros((wl.n_nodes, wl.state_width), np.int32)
    rc = lib.oracle_run(
        ctypes.c_int32(WORKLOAD_IDS[wl.name]),
        ctypes.c_uint64(seed),
        ctypes.c_int64(n_steps),
        ctypes.c_int64(cfg.pool_size),
        ctypes.c_int64(cfg.lat_min_ns),
        ctypes.c_int64(cfg.lat_max_ns),
        ctypes.c_uint64(cfg.loss_u32),
        ctypes.c_int64(cfg.proc_min_ns),
        ctypes.c_int64(cfg.proc_max_ns),
        ctypes.c_int64(cfg.clog_backoff_min_ns),
        ctypes.c_int64(cfg.clog_backoff_max_ns),
        ctypes.c_int64(cfg.time_limit_ns),
        ctypes.byref(now),
        ctypes.byref(trace),
        ctypes.byref(msg_count),
        ctypes.byref(halted),
        ctypes.byref(halt_time),
        ctypes.byref(overflow),
        node_state.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f"oracle_run failed with rc={rc}")
    return OracleResult(
        now=now.value,
        trace=trace.value,
        msg_count=msg_count.value,
        halted=bool(halted.value),
        halt_time=halt_time.value,
        overflow=overflow.value,
        node_state=node_state,
    )
