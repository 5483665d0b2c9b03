"""Engine determinism checks.

Port of ``madsim_tpu/engine/verify.py`` for the port's states: run the
same seeds twice, or through two lowerings, and compare the per-seed
trace hashes (and, across lowerings, the state fields the trace does not
see); any divergence names the first differing seed. The strongest form
is the C++ oracle compare (``engine/oracle.py``); this is the quick
self-check for any workload.

The JAX engine has several lowerings (dense and scatter layouts, int32
times); the port has one step program, so its "layouts" are the fused
run kernel against the plain eager step, on the card and on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..runtime.rand import DeterminismError
from .core import (
    CAUSAL_STATE_FIELDS,
    LATENCY_FIELDS,
    OBS_FIELDS,
    RETRY_STATE_FIELDS,
    STATE_FIELDS,
    STORAGE_FIELDS,
    EngineConfig,
    SimState,
    Workload,
    make_init,
    make_run,
    make_run_plain,
    resolve_device,
)

__all__ = [
    "DERIVED_FIELDS",
    "HISTORY_FIELDS",
    "LAYOUT_FIELDS",
    "DeterminismError",
    "check_determinism",
    "check_layouts",
    "compare_fields",
    "compare_traces",
]

# operation-history columns: outside the trace hash (the C++ oracle
# mirrors the hash and knows nothing of histories), so the determinism
# checks compare them directly
HISTORY_FIELDS = ("hist_count", "hist_drop", "hist_word", "hist_t")
# the sync discipline's columns, the fleet counters, the coverage and
# timeline columns, the latency tap's, the causal and the retry columns:
# outside the trace hash too (zero-size without the discipline, the taps
# or a policy), so both checks compare them directly
DERIVED_FIELDS = (*STORAGE_FIELDS, "met", *OBS_FIELDS, *LATENCY_FIELDS, *CAUSAL_STATE_FIELDS,
                  *RETRY_STATE_FIELDS)
# the fields check_layouts holds besides the trace and DERIVED_FIELDS:
# the reference's list
LAYOUT_FIELDS = (
    "now", "halted", "halt_time", "msg_count", "overflow", "node_state",
    "ev_valid", *HISTORY_FIELDS,
)
# check_layouts holds the first this many seeds against the CPU
CPU_SEEDS = 256


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _seed_of(a, s: int) -> int:
    return int(_np(a.seed).astype(np.int64).view(np.uint64)[s])


def compare_traces(a, b, what: str = "run", history: bool = True) -> None:
    """Raise :class:`DeterminismError` naming the first seed whose
    traces differ. ``a`` and ``b`` carry ``.trace`` and ``.seed``.

    With ``history=True`` the operation-history columns are compared
    too, where both carry them: they are outside the trace hash, so a
    divergence there would otherwise pass unseen."""
    ta, tb = _np(a.trace), _np(b.trace)
    if ta.shape != tb.shape:
        raise DeterminismError(
            f"{what}: batch shapes differ ({ta.shape} vs {tb.shape})"
        )
    diff = np.nonzero(ta != tb)[0]
    if diff.size:
        s = int(diff[0])
        raise DeterminismError(
            f"non-determinism detected in {what}: seed index {s} "
            f"(seed {_seed_of(a, s)}) produced trace {int(ta[s]) & (2**64 - 1):#x} "
            f"vs {int(tb[s]) & (2**64 - 1):#x}"
        )
    if not history:
        return
    for field in HISTORY_FIELDS:
        da, db = getattr(a, field, None), getattr(b, field, None)
        if da is None or db is None:
            continue  # compacted results without banked history columns
        da, db = _np(da), _np(db)
        if da.shape != db.shape:
            raise DeterminismError(
                f"{what}: history field {field!r} shapes differ "
                f"({da.shape} vs {db.shape}): runs used different "
                f"HistorySpec capacities"
            )
        if not np.array_equal(da, db):
            s = int(np.nonzero((da != db).reshape(da.shape[0], -1).any(axis=1))[0][0])
            raise DeterminismError(
                f"non-determinism detected in {what}: history field "
                f"{field!r} diverged at seed index {s} (seed {_seed_of(a, s)})"
            )


def compare_fields(a, b, what: str = "run", fields: tuple = LAYOUT_FIELDS) -> None:
    """Raise :class:`DeterminismError` naming the first of ``fields``
    that differs between ``a`` and ``b``, and its first seed."""
    for field in fields:
        da, db = _np(getattr(a, field)), _np(getattr(b, field))
        if da.shape != db.shape or not np.array_equal(da, db):
            s = 0 if da.shape != db.shape else int(
                np.nonzero((da != db).reshape(da.shape[0], -1).any(axis=1))[0][0]
            )
            raise DeterminismError(
                f"{what}: field {field!r} diverged at seed index {s} "
                f"(seed {_seed_of(a, s)})"
            )


def _plan_init(wl: Workload, cfg: EngineConfig, device, plan, taps: dict):
    """``init(seeds)``, with ``plan``'s compiled rows when there is one."""
    if plan is None:
        return make_init(wl, cfg, device=device, **taps)
    init = make_init(wl, cfg, device=device, plan_slots=plan.slots, **taps)
    return lambda seeds: init(seeds, plan.compile_batch(seeds, wl=wl))


def check_determinism(
    wl: Workload, cfg: EngineConfig, seeds, n_steps: int, device=None,
    metrics: bool = False, cov_words: int = 0, timeline_cap: int = 0,
    cov_hitcount: bool = False, latency=None, plan=None, causal: bool = False,
) -> None:
    """Run the workload twice over ``seeds`` on ``device`` (the card
    unless the caller asks for the CPU); raise on any divergence of the
    trace, the history, the storage columns or the columns of the taps
    the run carries (``metrics``, ``cov_words``, ``timeline_cap``,
    ``cov_hitcount``, ``latency``, ``causal``). A fault ``plan``
    (``chaos.FaultPlan``, a client army among its specs) seeds both
    runs' pools.

    Catches hidden nondeterminism in handlers, the way the reference's
    two-run RNG-log compare catches nondeterministic user code."""
    seeds = np.asarray(seeds, np.uint64)
    taps = dict(metrics=metrics, cov_words=cov_words, timeline_cap=timeline_cap,
                cov_hitcount=cov_hitcount, latency=latency, causal=causal)
    init = _plan_init(wl, cfg, device, plan, taps)
    run = make_run(wl, cfg, n_steps, **taps)
    a = run(init(seeds))
    b = run(init(seeds))
    compare_traces(a, b, what=f"{wl.name} x2")
    compare_fields(a, b, what=f"{wl.name} x2", fields=DERIVED_FIELDS)


def check_layouts(
    wl: Workload, cfg: EngineConfig, seeds, n_steps: int, device=None,
    metrics: bool = False, cov_words: int = 0, timeline_cap: int = 0,
    cov_hitcount: bool = False, latency=None, plan=None, causal: bool = False,
) -> None:
    """Run ``seeds`` through the fused kernel on the card and through
    the plain eager step on the card, and the first 256 of them through
    the plain step on the CPU; raise on any difference of trace or of
    :data:`LAYOUT_FIELDS` and :data:`DERIVED_FIELDS`, under an optional
    fault ``plan``. On the CPU the port has one lowering, so a CPU
    ``device`` raises ``ValueError``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        raise ValueError(
            "check_layouts compares the fused run kernel with the plain "
            "step; on the CPU the port has one lowering, the plain step, "
            "so there is nothing to compare (use check_determinism)"
        )
    seeds = np.asarray(seeds, np.uint64)
    taps = dict(metrics=metrics, cov_words=cov_words, timeline_cap=timeline_cap,
                cov_hitcount=cov_hitcount, latency=latency, causal=causal)
    init = _plan_init(wl, cfg, dev, plan, taps)
    fused = make_run(wl, cfg, n_steps, **taps)(init(seeds))
    plain = make_run_plain(wl, cfg, n_steps, **taps)(init(seeds))
    k = min(CPU_SEEDS, len(seeds))
    cpu = make_run_plain(wl, cfg, n_steps, **taps)(
        _plan_init(wl, cfg, "cpu", plan, taps)(seeds[:k]))
    head = SimState(**{f: getattr(fused, f)[:k] for f in STATE_FIELDS})
    for what, a, b in (
        (f"{wl.name} fused-vs-plain on {dev}", fused, plain),
        (f"{wl.name} fused-vs-plain on cpu", head, cpu),
    ):
        compare_traces(a, b, what=what)
        compare_fields(a, b, what=what)
        compare_fields(a, b, what=what, fields=DERIVED_FIELDS)
