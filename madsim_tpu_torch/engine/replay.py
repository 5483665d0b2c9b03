"""Single-seed replay: a failing seed becomes a readable event timeline.

Port of ``madsim_tpu/engine/replay.py``. A seed's evidence in the
batched engine is a uint64 trace hash, good for equality and useless
for a human chasing a bug. :func:`replay` re-runs one seed through the
C++ oracle (``engine/oracle.py``) with its per-dispatch event log
attached, and :func:`format_timeline` prints what happened, in order,
with virtual times, node ids and handler names.

The log rows are the tuples the trace hash folds, so :func:`refold`
recomputes the hash from the timeline: it equals the oracle's trace and
the batched engine's, which proves that the story and the evidence are
the same events. Typical flow with the chaos search::

    report = search_seeds(wl, cfg, invariant, n_seeds=65536, ...)
    for seed in report.failing_seeds[:3]:
        print(format_timeline(*replay(wl, cfg, int(seed), 600), wl=wl))
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from . import core as _core
from . import oracle as _oracle
from .core import FIRST_EXT_KIND, FIRST_USER_KIND, _TRACE_MIX, _TRACE_PRIME, EngineConfig, Workload

__all__ = ["ReplayEvent", "replay", "refold", "format_timeline"]

# from the KIND_* constants, so the timeline cannot drift from the
# engine's numbering
_ENGINE_KIND_NAMES = {
    v: k[len("KIND_"):] for k, v in vars(_core).items() if k.startswith("KIND_")
}
_M64 = (1 << 64) - 1


@dataclass(frozen=True)
class ReplayEvent:
    """One dispatched event: the tuple the trace hash folds.

    ``emit_ns`` is the clock at which the event entered the pool (for a
    message, its sender's dispatch), as the timeline ring captures it;
    -1 = not captured (oracle replays). ``seq``, ``parent`` and ``lam``
    are the causal columns of a ring captured with ``causal=True``: the
    dispatch's sequence number, the seq of the dispatch that emitted the
    event (or a ``PARENT_*`` class below zero) and the node's Lamport
    clock after the dispatch; -1, -1 and 0 when not captured. None of
    them is part of the trace."""

    time_ns: int
    kind: int
    node: int
    src: int  # -1 = timer or engine event, else the sending node
    args: tuple
    pay: tuple
    emit_ns: int = -1
    seq: int = -1
    parent: int = -1
    lam: int = 0

    def kind_name(self, wl: Workload | None = None) -> str:
        # the extended chaos kinds (>= FIRST_EXT_KIND) are engine kinds too
        if self.kind < FIRST_USER_KIND or self.kind >= FIRST_EXT_KIND:
            return _ENGINE_KIND_NAMES.get(self.kind, f"engine[{self.kind}]")
        u = self.kind - FIRST_USER_KIND
        names = getattr(wl, "handler_names", None) if wl is not None else None
        if names and u < len(names):
            return str(names[u])
        return f"user[{u}]"


def replay(
    wl: Workload,
    cfg: EngineConfig,
    seed: int,
    n_steps: int,
    cap: int = 4096,
    **model_kwargs,
):
    """Re-run one seed through the oracle with event logging.

    Returns ``(events, result)``: the dispatched events and the
    oracle's :class:`~.oracle.OracleResult`. The log buffer grows until
    the whole run fits, so the timeline is never cut short.
    ``model_kwargs`` override the workload's ``model_params``, as for
    :func:`~.oracle.run_oracle`.
    """
    lib = _oracle.load()
    lib.oracle_log_count.restype = ctypes.c_int64
    lib.oracle_set_log.restype = None
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.oracle_set_log.argtypes = [p64, p32, p32, p32, p32, p32, ctypes.c_int64]
    while True:
        t = np.zeros(cap, np.int64)
        kind = np.zeros(cap, np.int32)
        node = np.zeros(cap, np.int32)
        src = np.zeros(cap, np.int32)
        args = np.zeros((cap, 4), np.int32)
        pay = np.zeros((cap, 4), np.int32)
        # the log buffers are process globals (oracle.cpp g_log_*): hold
        # the oracle lock across attach, run and detach, and detach even
        # on failure, so no other run writes through the pointers
        with _oracle.ORACLE_LOCK:
            try:
                lib.oracle_set_log(
                    t.ctypes.data_as(p64), kind.ctypes.data_as(p32),
                    node.ctypes.data_as(p32), src.ctypes.data_as(p32),
                    args.ctypes.data_as(p32), pay.ctypes.data_as(p32),
                    ctypes.c_int64(cap),
                )
                res = _oracle.run_oracle(wl, cfg, seed, n_steps, **model_kwargs)
                count = int(lib.oracle_log_count())
            finally:
                lib.oracle_set_log(None, None, None, None, None, None, 0)
        if count <= cap:
            break
        cap = max(cap * 2, count)
    events = [
        ReplayEvent(
            time_ns=int(t[i]),
            kind=int(kind[i]),
            node=int(node[i]),
            src=int(src[i]),
            args=tuple(int(x) for x in args[i]),
            pay=tuple(int(x) for x in pay[i]),
        )
        for i in range(count)
    ]
    return events, res


def refold(events, wl: Workload) -> int:
    """Recompute the trace hash from a replay's events (the engine's
    ``_trace_fold``). Equals the oracle's and the batched engine's trace
    for the same (seed, config, steps), as a uint64."""
    mix = _TRACE_MIX & _M64
    trace = 0
    for e in events:
        h = (e.time_ns * mix) & _M64
        h ^= (e.kind & 0xFFFFFFFF) << 32
        h ^= (e.node & 0xFFFFFFFF) << 40
        h &= _M64
        for j in range(4):  # words past args_words are zero
            h ^= (e.args[j] & 0xFFFFFFFF) << (8 * j)
        h &= _M64
        if wl.payload_words > 0:
            acc = 0
            for w in range(wl.payload_words):
                acc += (e.pay[w] & 0xFFFFFFFF) * (mix ^ w)
            h ^= acc & _M64
        trace = (trace * _TRACE_PRIME + h) & _M64
    return trace


def format_timeline(events, res=None, wl: Workload | None = None) -> str:
    """Render a replay as text, one dispatched event per line."""
    lines = []
    n_args = getattr(wl, "args_words", 4) if wl is not None else 4
    for e in events:
        origin = "timer" if e.src < 0 else f"node{e.src}"
        # positions matter (args[1] == 0 is information): print the
        # declared width verbatim
        argstr = ",".join(str(a) for a in e.args[:n_args])
        lines.append(
            f"[{e.time_ns / 1e6:>12.3f}ms] node{e.node} <- "
            f"{e.kind_name(wl)}({argstr}) from {origin}"
        )
    if res is not None:
        lines.append(
            f"-- halted={res.halted} at {res.halt_time / 1e6:.3f}ms, "
            f"{res.msg_count} msgs, trace {res.trace:#018x}"
        )
    return "\n".join(lines)
