"""Batched chaos-schedule search: hunt seeds that violate an invariant.

Port of ``madsim_tpu/engine/search.py``. Sweep thousands of seeded
chaos schedules in one batched run and report every seed whose final
state breaks a user invariant, each with its repro recipe::

    report = search_seeds(
        wl, cfg,
        invariant=lambda view: view["node_state"][:, 0, 0] >= 1,
        n_seeds=4096, max_steps=900,
    )
    report.failing_seeds  # -> np.ndarray of violating seeds
    report.banner()       # -> repro lines, seed + config hash each

The invariant is a host-side predicate over the final batched state
(numpy views with the JAX package's dtypes), returning a boolean array
over the seed axis, True where the invariant holds. Re-running any
failing seed, alone or in any batch, reproduces the identical trace.

A ``history_invariant`` judges the recorded operation histories
(``check.BatchHistory``) on the host, instead of, or besides, the final
state: the ``check`` package's detectors are such predicates. A
``device_check`` (``check.device`` screens) gives the same verdicts on
the histories' own device: the host reads a packed verdict word per 32
seeds and the full histories of the flagged seeds only.

A fault ``plan`` (``chaos.FaultPlan`` or ``LiteralPlan``) compiles per
seed into pre-seeded pool rows; its hash joins the repro banner, so
``(seed, config, plan)`` is the repro key.

``metrics=True`` folds the fleet counters (``engine.core.MET_*``) into
``report.met``, and the banner splits the seeds by how they stopped.
``cov_words`` (with ``cov_hitcount``) returns each seed's coverage
bitmap as ``report.cov``, and ``timeline_cap`` its timeline ring as
``report.timeline`` (``obs.decode_timeline`` reads it); a ring that
overflowed is named in the banner and voids no verdict.
``latency=LatencySpec(...)`` runs the tail-latency tap: each seed's
sketch and its counts come back as ``report.lat_hist`` and
``lat_count`` (reduce them with ``obs.latency_reduce``, judge them with
``check.slo_bounded`` as the invariant). ``causal=True`` folds causal
provenance: each seed's final Lamport clocks come back as ``report.lam``
(``obs.fleet_reduce(met, lam=)`` folds the fleet's causal depth and
width), and with ``timeline_cap`` the ring's ``tl_seq``, ``tl_parent``
and ``tl_lam`` ride ``report.timeline``, from which
``obs.causal.causal_slice`` and ``check.device.violation_cones`` cut a
violation's backward cone.

A plan whose client army carries a ``chaos.RetryPolicy`` runs the
engine's retry timers (``retry=plan.retry_spec()`` unless ``retry`` is
given); ``met`` counts the re-sends and give-ups.

On a CUDA state the sweep runs the run kernel: ``make_run_while`` (the
run and drain kernels), or with ``compact=True`` the compacted runner's
one stop-at-halt launch.
"""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace
from typing import Callable, Mapping

import numpy as np
import torch

from ..check.device import (
    as_screens, pack_verdicts, pack_verdicts_host, screen_ok, unpack_verdicts,
    verdict_words_to_numpy,
)
from ..check.history import BatchHistory
from .compact import RESULT_FIELDS, SCREEN_FIELDS, make_run_compacted
from .convert import field_to_numpy
from .core import (
    HALT_DONE,
    HALT_IDLE,
    HALT_TIME_LIMIT,
    MET_HALT_CODE,
    STATE_FIELDS,
    TIMELINE_FIELDS,
    EngineConfig,
    Workload,
    make_init,
    make_run_while,
    resolve_device,
)

__all__ = ["SearchReport", "make_sweep", "search_seeds"]

# built (init, run) pairs, so that repeated searches over the same
# workload, config, step budget and path (the repro workflow) reuse
# them. A workload is named by its factory's name, shape, parameters
# and history spec, as the kernel registry names it. The run is an
# obs.prof.AotProgram, so its build (the run's construction and the
# kernel library's build or load) is timed and retrace-counted, and the
# library's share of a dispatch is separable from execution
# (SearchReport.build_wall_s).
_RUN_CACHE: dict = {}


def _build_init_run(wl: Workload, cfg: EngineConfig, max_steps: int,
                    compact: bool, device, hist_screen=None, plan_slots: int = 0,
                    dup_rows: bool = False, metrics: bool = False, cov_words: int = 0,
                    cov_hitcount: bool = False, timeline_cap: int = 0, latency=None,
                    causal: bool = False, retry=None):
    # the one construction of a sweep's (init, run) pair, for make_sweep
    # and search_seeds alike; only the compacted runner embeds a screen.
    # The run comes back unbuilt: a function that makes it
    taps = dict(metrics=metrics, cov_words=cov_words, cov_hitcount=cov_hitcount,
                timeline_cap=timeline_cap, latency=latency, causal=causal, retry=retry)
    init = make_init(wl, cfg, device=device, plan_slots=plan_slots, **taps)

    def build():
        if compact:
            return make_run_compacted(wl, cfg, max_steps, hist_screen=hist_screen,
                                      dup_rows=dup_rows, **taps)
        return make_run_while(wl, cfg, max_steps, dup_rows=dup_rows, **taps)

    return init, build


def make_sweep(
    wl: Workload,
    cfg: EngineConfig,
    max_steps: int,
    *,
    device=None,
    plan_slots: int = 0,
    dup_rows: bool = False,
    cov_words: int = 0,
    metrics: bool = False,
    timeline_cap: int = 0,
    cov_hitcount: bool = False,
    latency=None,
    causal: bool = False,
    retry=None,
):
    """Build ``sweep(seeds, rows=None) -> view``: init the seed
    batch (with ``plan_slots`` rows of a compiled plan), run
    ``make_run_while`` to the step cap, and return the final state as a
    ``{field name: device tensor}`` view, with no host transfer and no
    invariant. ``metrics``, ``cov_words``, ``timeline_cap``,
    ``cov_hitcount``, ``latency`` and ``causal`` run the observability
    taps, ``retry`` (a ``RetrySpec``) the client-retry timers."""
    init, build = _build_init_run(wl, cfg, max_steps, False, resolve_device(device),
                                  plan_slots=plan_slots, dup_rows=dup_rows, metrics=metrics,
                                  cov_words=cov_words, cov_hitcount=cov_hitcount,
                                  timeline_cap=timeline_cap, latency=latency, causal=causal,
                                  retry=retry)
    run = build()

    def sweep(seeds, rows=None):
        out = run(init(seeds, rows) if plan_slots else init(seeds))
        return {f: getattr(out, f) for f in STATE_FIELDS}

    return sweep


def _compiled_run(wl: Workload, cfg: EngineConfig, max_steps: int,
                  compact: bool, dev, hist_screen=None, plan_slots: int = 0,
                  dup_rows: bool = False, metrics: bool = False, cov_words: int = 0,
                  cov_hitcount: bool = False, timeline_cap: int = 0, latency=None,
                  causal: bool = False, retry=None):
    from .fused import workload_shape

    key = (wl.name, workload_shape(wl), wl.model_params, wl.history, wl.durable_cols,
           wl.durable_sync, wl.cov_features is not None, wl.lat_markers, cfg.hash(),
           max_steps, compact, str(dev), hist_screen, plan_slots, dup_rows, metrics,
           cov_words, cov_hitcount, timeline_cap, latency, causal, retry)
    if key not in _RUN_CACHE:
        from ..obs.prof import AotProgram

        init, build = _build_init_run(wl, cfg, max_steps, compact, dev, hist_screen,
                                      plan_slots, dup_rows, metrics, cov_words,
                                      cov_hitcount, timeline_cap, latency, causal, retry)
        taps = dict(cov_words=cov_words, cov_hitcount=cov_hitcount,
                    timeline_cap=timeline_cap, causal=causal)
        _RUN_CACHE[key] = (init, AotProgram(
            "engine.search.run", key, build,
            library=lambda: _library_build_s(wl, dev, dup_rows, cfg.pool_size, taps),
            cost=lambda: launch_cost(wl, cfg, dev, dup_rows, taps),
        ))
    return _RUN_CACHE[key]


def launch_cost(wl: Workload, cfg: EngineConfig, dev, dup_rows: bool = False,
                taps: dict | None = None) -> dict:
    """The launch shape of the workload's run kernel at the config's
    pool under ``taps`` (``fused.library_for``'s keywords;
    ``obs.prof.program_cost``) on the card; {} on the CPU."""
    if dev.type != "cuda":
        return {}
    from ..obs.prof import program_cost
    from .fused import library_for

    return program_cost(library_for(wl, cfg.pool_size, dup_rows, **(taps or {})),
                        cfg.pool_size)


def _library_build_s(wl: Workload, dev, dup_rows: bool = False, pool: int = 0,
                     taps: dict | None = None) -> float:
    """The seconds spent building and loading the workload's kernel
    library at ``pool`` under ``taps`` on its first use in this process,
    else 0.0."""
    if dev.type != "cuda":
        return 0.0
    from .fused import KERNEL, library_for

    spec = library_for(wl, pool, dup_rows, **(taps or {}))
    if KERNEL.is_loaded(spec):
        return 0.0
    t0 = time.perf_counter()  # lint: allow(wall-clock)
    KERNEL.load(spec)
    return time.perf_counter() - t0  # lint: allow(wall-clock)


@dataclasses.dataclass
class SearchReport:
    """Outcome of one batched invariant sweep."""

    workload: str
    config_hash: str
    seeds: np.ndarray  # every seed searched, uint64
    ok: np.ndarray  # (S,) bool: invariant held
    halted: np.ndarray  # (S,) bool
    # (S,) bool: the event pool dropped events or the history buffer
    # dropped records, the verdict is unreliable
    overflowed: np.ndarray
    traces: np.ndarray  # (S,) uint64 per-seed trace hashes
    # the largest per-seed step coordinate; under compact=True a row's
    # counter stops when it is banked
    steps: int
    # seconds this call spent building the run kernel's library: nonzero
    # only on its first use in the process, and 0.0 on the CPU
    build_wall_s: float = 0.0
    # (S,) int64 per-seed halt clock (0 while running)
    halt_times: np.ndarray | None = None
    # which channel voided which seeds; overflowed is their union. The
    # history one is None when the workload records nothing
    pool_overflowed: np.ndarray | None = None
    hist_dropped: np.ndarray | None = None
    # device screens (device_check=...): each seed's verdict (True =
    # clean); its packed form, ceil(S/32) uint32 words (what crossed to
    # the host on the lockstep path); the escalation input, the full
    # histories of exactly the flagged seeds that did not overflow, as a
    # check.BatchHistory over the flagged_idx rows (feed them to the
    # exact checker); and, on the compact path, the records the fold
    # took out of each seed
    screen_ok: np.ndarray | None = None
    verdict_words: np.ndarray | None = None
    flagged_idx: np.ndarray | None = None
    flagged_history: object | None = None
    hist_fold: np.ndarray | None = None
    # the fault plan's hash, part of the repro key (None: no plan)
    plan_hash: str | None = None
    # (S, N_METRICS) int32 fleet counters (metrics=True), else None; the
    # MET_HALT_CODE column says how each seed stopped
    met: np.ndarray | None = None
    # (S, cov_words) uint32 coverage bitmaps (cov_words > 0), else None
    cov: np.ndarray | None = None
    # the timeline rings (timeline_cap > 0): a namespace of the seven
    # tl_* columns (ten with causal=True), each seed-leading
    # (obs.decode_timeline reads one seed's stream); tl_dropped marks the
    # seeds whose ring overflowed, which voids no verdict (the timeline
    # is forensics, not evidence)
    timeline: object | None = None
    tl_dropped: np.ndarray | None = None
    # the tail-latency tap (latency=LatencySpec(...)): each seed's
    # (P, N_LAT_BUCKETS) sketch and its completed-op count, else None;
    # lat_dropped marks the seeds whose markers named op ids outside
    # LatencySpec.ops (their sketches undercount)
    lat_hist: np.ndarray | None = None
    lat_count: np.ndarray | None = None
    lat_dropped: np.ndarray | None = None
    # causal provenance (causal=True): the final per-node Lamport clocks,
    # (S, N) uint32, for obs.fleet_reduce(met, lam=); the ring's causal
    # columns ride report.timeline
    lam: np.ndarray | None = None

    @property
    def failing_seeds(self) -> np.ndarray:
        """Violations on seeds whose simulation was trustworthy (no
        pool or history overflow, see :attr:`overflowed_seeds`)."""
        return self.seeds[~self.ok & ~self.overflowed]

    @property
    def unhalted_seeds(self) -> np.ndarray:
        """Seeds still running at max_steps: schedules the step budget
        could not finish (raise max_steps or treat as liveness bugs)."""
        return self.seeds[~self.halted]

    @property
    def overflowed_seeds(self) -> np.ndarray:
        """Seeds whose event pool dropped events (raise
        ``cfg.pool_size``) or whose history buffer dropped records
        (raise ``HistorySpec.capacity`` or the model's
        ``hist_capacity``): their verdicts are simulator artifacts, not
        evidence."""
        return self.seeds[self.overflowed]

    def banner(self, limit: int = 10) -> str:
        """Repro recipe per failing seed, with the halt and overflow
        counts; the reference's wording."""
        bad = self.failing_seeds
        s = len(self.seeds)
        lines = [
            f"chaos search over {s} seeds of "
            f"{self.workload!r}: {len(bad)} violation(s)",
        ]
        n_halt = int(np.asarray(self.halted).sum())
        if self.met is not None:
            codes = np.asarray(self.met)[:, MET_HALT_CODE]
            done = int((codes == HALT_DONE).sum())
            tlim = int((codes == HALT_TIME_LIMIT).sum())
            idle = int((codes == HALT_IDLE).sum())
            lines.append(
                f"  halted {n_halt}/{s}: {done} workload-halt, "
                f"{tlim} time-limit; {idle} idle (empty pool), "
                f"{s - n_halt - idle} still running at the step cap"
            )
        elif n_halt < s:
            lines.append(
                f"  halted {n_halt}/{s}; {s - n_halt} still running at "
                f"the step cap (run with metrics=True for the halt-"
                f"reason breakdown)"
            )
        if self.overflowed.any():
            pool = (
                int(np.asarray(self.pool_overflowed).sum())
                if self.pool_overflowed is not None else 0
            )
            hist = (
                int(np.asarray(self.hist_dropped).sum())
                if self.hist_dropped is not None else 0
            )
            detail = f" (pool {pool}, history {hist})" if pool or hist else ""
            lines.append(
                f"  WARNING: {int(self.overflowed.sum())} seed(s) "
                f"overflowed the event pool or history buffer{detail}; "
                f"excluded (raise pool_size / HistorySpec capacity)"
            )
        if self.tl_dropped is not None and self.tl_dropped.any():
            lines.append(
                f"  WARNING: {int(self.tl_dropped.sum())} seed(s) "
                f"overflowed the timeline ring (raise timeline_cap; "
                f"verdicts unaffected — the timeline is forensics only)"
            )
        if self.lat_dropped is not None and self.lat_dropped.any():
            lines.append(
                f"  WARNING: {int(self.lat_dropped.sum())} seed(s) "
                f"dropped latency markers (op ids outside "
                f"LatencySpec.ops) — their sketches undercount; size "
                f"LatencySpec.ops to cover every army op id"
            )
        if self.screen_ok is not None:
            fold = (
                f", {int(self.hist_fold.sum())} records prefix-compacted"
                if self.hist_fold is not None else ""
            )
            lines.append(
                f"  device screen: {len(self.flagged_idx)} flagged seed(s) escalated "
                f"with full histories ({len(self.verdict_words)} verdict "
                f"words transferred{fold})"
            )
        plan = f" plan_hash={self.plan_hash}" if self.plan_hash else ""
        for seed in bad[:limit]:
            lines.append(
                f"  seed {int(seed)}: rerun with seeds=[{int(seed)}] "
                f"config_hash={self.config_hash}{plan}"
            )
        if len(bad) > limit:
            lines.append(f"  ... and {len(bad) - limit} more")
        return "\n".join(lines)


def _state_view(out, keep_device: tuple = ()) -> Mapping[str, np.ndarray]:
    """Host-side numpy views of every final-state field, keyed by name,
    with the JAX package's dtypes: invariants can reach anything,
    including the paused and clog chaos state and the raw event pool.
    The fields in ``keep_device`` stay tensors on their device (a
    screened sweep never copies the history columns whole)."""
    return {
        f: getattr(out, f) if f in keep_device else field_to_numpy(f, getattr(out, f))
        for f in STATE_FIELDS
    }


def _screen(screens, out, view, n_seeds: int, compact: bool):
    """The device screens' verdicts and escalation: ``(ok, verdict
    words, flagged_idx, flagged_history)``. On the lockstep path the
    screens run on ``out``'s device and the host reads the packed
    words, then the flagged rows of the two history columns gathered
    there; on the compact path the verdicts came banked with the
    prefix-compacted columns, whose flagged seeds are verbatim."""
    drop = np.asarray(view["hist_drop"])
    if compact:
        ok = np.asarray(view["hist_ok"], bool)
        words = pack_verdicts_host(ok)
        flagged = np.nonzero(~ok & ~(drop > 0))[0]
        word, t = view["hist_word"][flagged], view["hist_t"][flagged]
    else:
        words = verdict_words_to_numpy(pack_verdicts(screen_ok(
            screens, out.hist_word, out.hist_t, out.hist_count, out.hist_drop)))
        ok = unpack_verdicts(words, n_seeds)
        flagged = np.nonzero(~ok & ~(drop > 0))[0]
        rows = torch.as_tensor(flagged, device=out.hist_word.device)
        word = field_to_numpy("hist_word", out.hist_word[rows])
        t = field_to_numpy("hist_t", out.hist_t[rows])
    history = BatchHistory(word=word, t=t, count=np.asarray(view["hist_count"])[flagged],
                           drop=drop[flagged])
    return ok, words, flagged, history


def search_seeds(
    wl: Workload,
    cfg: EngineConfig,
    invariant: Callable[[Mapping[str, np.ndarray]], np.ndarray],
    n_seeds: int = 4096,
    max_steps: int = 1000,
    seed_base: int = 0,
    require_halt: bool = True,
    *,
    compact: bool = False,
    seeds: np.ndarray | None = None,
    device=None,
    history_invariant: Callable | None = None,
    plan=None,
    plan_rows=None,
    plan_hash: str | None = None,
    dup_rows: bool | None = None,
    cov_words: int = 0,
    metrics: bool = False,
    timeline_cap: int = 0,
    cov_hitcount: bool = False,
    latency=None,
    device_check=None,
    causal: bool = False,
    retry=None,
) -> SearchReport:
    """Run ``n_seeds`` chaos schedules (``seed_base`` on, or the
    explicit ``seeds``) and evaluate ``invariant`` on the final states
    and ``history_invariant`` on the recorded histories (either may be
    None, not both).

    ``require_halt=True`` (default) also counts a seed that never halts
    within ``max_steps`` as a violation: its scenario never reached its
    goal, the liveness bug a chaos search hunts.

    ``compact=True`` runs the compacted runner (engine/compact.py):
    per-seed values identical, but the invariant's view holds only
    ``RESULT_FIELDS``, not the raw event pool or the clog and alive
    arrays.

    ``history_invariant`` takes a ``check.BatchHistory`` of every seed
    and returns an ``(S,)`` boolean array, True where the history is
    clean. A seed whose history buffer dropped records reaches it as an
    empty history and is quarantined like a pool overflow.

    ``device_check`` (a ``check.device.HistoryScreen`` or a tuple of
    them) judges the histories on the sweep's device instead: the host
    reads ``ceil(S/32)`` packed verdict words and the full histories of
    the flagged seeds only (``report.flagged_history``, the input of
    the exact checker). Its verdicts equal the host path's
    (``check.device.screens_invariant(screens)``), overflowed seeds
    quarantined alike. With ``compact=True`` the screens run on each
    bank and prefix-compact its columns (``report.hist_fold``; see
    ``make_run_compacted``). It excludes ``history_invariant``.

    ``plan`` injects a fault plan (``chaos.FaultPlan`` or
    ``LiteralPlan``): each seed's compiled fault events become
    pre-seeded pool rows, and the plan's hash joins the banner
    (``report.plan_hash``). It needs ``cfg.pool_size >= n_nodes +
    plan.slots``. ``plan_rows`` gives pre-compiled rows instead (one row
    per seed; label them with ``plan_hash``). ``dup_rows`` runs the step
    with the duplication rows; with a ``plan`` it defaults to
    ``plan.uses_dup()``.

    ``metrics=True`` returns each seed's fleet counters as
    ``report.met`` (``engine.core.MET_*``). ``cov_words=CW`` (a power of
    two) returns each seed's coverage bitmap as ``report.cov`` (with
    ``cov_hitcount`` keyed by hit-count classes), and ``timeline_cap=T``
    its timeline ring as ``report.timeline``; seeds whose ring
    overflowed are ``report.tl_dropped``, named in the banner, with
    their verdicts unchanged. ``latency=LatencySpec(...)`` returns each
    seed's latency sketch and completed-op count (``report.lat_hist``,
    ``lat_count``; ``lat_dropped`` the seeds with out-of-range markers,
    named in the banner); a plan whose client army's op ids exceed
    ``LatencySpec.ops`` is refused.

    ``device`` is where the sweep runs, the card unless the caller asks
    for the CPU. ``causal=True`` folds causal provenance: the final
    per-node Lamport clocks return as ``report.lam``, and with
    ``timeline_cap`` the ring's ``tl_seq``, ``tl_parent`` and ``tl_lam``
    ride ``report.timeline`` (``check.device.violation_cones`` cuts each
    flagged seed's cone from them).

    ``retry`` (an ``engine.RetrySpec``) runs the client-retry timers;
    with a ``plan`` it defaults to ``plan.retry_spec()``, the policy of
    its client army, if one carries a policy. Pass it explicitly with
    ``plan_rows`` or a ``LiteralPlan``, which carry no policy.
    """
    if history_invariant is not None and wl.history is None:
        raise ValueError(
            f"history_invariant needs operation histories, but workload "
            f"{wl.name!r} has Workload.history=None"
        )
    screens = None
    if device_check is not None:
        screens = as_screens(device_check)
        if wl.history is None:
            raise ValueError(
                f"device_check judges operation histories, but workload "
                f"{wl.name!r} has Workload.history=None"
            )
        if history_invariant is not None:
            raise ValueError(
                "pass device_check OR history_invariant, not both: they "
                "are the same verdict on two execution paths (compare "
                "them via check.device.screens_invariant in a test, not "
                "in one sweep)"
            )
    if invariant is None and history_invariant is None and screens is None:
        raise ValueError(
            "need an invariant, a history_invariant or a device_check"
        )
    if plan is not None and plan_rows is not None:
        raise ValueError("pass plan OR plan_rows, not both")
    if seeds is None:
        seeds = np.arange(seed_base, seed_base + n_seeds, dtype=np.uint64)
    else:
        seeds = np.asarray(seeds, np.uint64)
        if seeds.ndim != 1:
            raise ValueError(f"seeds must be 1-D, got shape {seeds.shape}")
        n_seeds = len(seeds)
    if plan is not None:
        plan_slots = int(plan.slots)
        if dup_rows is None:
            dup_rows = bool(plan.uses_dup())
        if latency is not None:
            # a client army whose op ids exceed the latency columns would
            # drop every out-of-range marker: a build error, not a count
            for spec in getattr(plan, "specs", ()):
                ob = getattr(spec, "op_base", None)
                no = getattr(spec, "n_ops", None)
                if ob is not None and no is not None and ob + no > latency.ops:
                    raise ValueError(
                        f"{type(spec).__name__} op ids [{ob}, {ob + no}) exceed "
                        f"LatencySpec.ops={latency.ops}; size the spec to cover "
                        f"every army op id"
                    )
        if cfg.time_limit_ns and hasattr(plan, "validate_windows"):
            # a window opening after the clock cap can never fire
            plan.validate_windows(cfg.time_limit_ns)
        rows = plan.compile_batch(seeds, wl=wl)
        if plan_hash is None:
            plan_hash = plan.hash()
        if retry is None and hasattr(plan, "retry_spec"):
            retry = plan.retry_spec()
    elif plan_rows is not None:
        rows = plan_rows
        plan_slots = int(np.asarray(rows.time).shape[1])
        if np.asarray(rows.time).shape[0] != n_seeds:
            raise ValueError(
                f"plan_rows carries {np.asarray(rows.time).shape[0]} rows "
                f"for {n_seeds} seeds"
            )
    else:
        rows, plan_slots = None, 0
    dup_rows = bool(dup_rows)
    dev = resolve_device(device)
    init, run = _compiled_run(wl, cfg, max_steps, compact, dev,
                              screens if compact else None, plan_slots, dup_rows, metrics,
                              cov_words, cov_hitcount, timeline_cap, latency, causal, retry)
    out = run(init(seeds, rows) if rows is not None else init(seeds))
    build_wall_s = run.last_compile_s
    if compact:
        fields = RESULT_FIELDS + SCREEN_FIELDS if screens is not None else RESULT_FIELDS
        view = {f: getattr(out, f) for f in fields}
    else:
        view = _state_view(
            out, keep_device=("hist_word", "hist_t") if screens is not None else ())
    if invariant is not None:
        ok = np.asarray(invariant(view), dtype=bool)
        if ok.shape != (n_seeds,):
            raise ValueError(
                f"invariant must return a ({n_seeds},) boolean array, "
                f"got shape {ok.shape}"
            )
    else:
        ok = np.ones((n_seeds,), dtype=bool)
    pool_overflowed = np.asarray(view["overflow"]) > 0
    overflowed = pool_overflowed
    dev_ok = verdict_words = flagged_idx = flagged_history = None
    if screens is not None:
        dev_ok, verdict_words, flagged_idx, flagged_history = _screen(
            screens, out, view, n_seeds, compact)
        ok = ok & dev_ok
    if history_invariant is not None:
        bh = BatchHistory.from_view(view)
        hist_over = np.asarray(bh.drop) > 0
        if hist_over.any():
            # a seed that dropped records reaches the invariant as an
            # EMPTY history: its verdict is discarded by the quarantine
            # below, and a strict per-seed checker must not crash the
            # sweep on a seed it will never judge
            bh = BatchHistory(
                word=bh.word, t=bh.t,
                count=np.where(hist_over, 0, np.asarray(bh.count)).astype(np.int32),
                drop=np.zeros_like(np.asarray(bh.drop)),
            )
        hok = np.asarray(history_invariant(bh), dtype=bool)
        if hok.shape != (n_seeds,):
            raise ValueError(
                f"history_invariant must return a ({n_seeds},) boolean "
                f"array, got shape {hok.shape}"
            )
        ok = ok & hok
    hist_dropped = None
    if wl.history is not None:
        # dropped records void the verdict whether or not a history
        # predicate ran
        hist_dropped = np.asarray(view["hist_drop"]) > 0
        overflowed = overflowed | hist_dropped
    halted = view["halted"]
    if require_halt:
        ok = ok & halted
    tl = tl_dropped = None
    if timeline_cap:
        cols = TIMELINE_FIELDS + (("tl_seq", "tl_parent", "tl_lam") if causal else ())
        tl = SimpleNamespace(**{f: np.asarray(view[f]) for f in cols})
        tl_dropped = tl.tl_drop > 0
    return SearchReport(
        workload=wl.name,
        config_hash=cfg.hash(),
        seeds=seeds,
        ok=ok,
        halted=halted,
        overflowed=overflowed,
        traces=view["trace"],
        steps=int(view["step"].max(initial=0)),
        build_wall_s=build_wall_s,
        halt_times=view["halt_time"],
        pool_overflowed=pool_overflowed,
        hist_dropped=hist_dropped,
        screen_ok=dev_ok,
        verdict_words=verdict_words,
        flagged_idx=flagged_idx,
        flagged_history=flagged_history,
        hist_fold=view["hist_fold"] if screens is not None and compact else None,
        plan_hash=plan_hash,
        met=np.asarray(view["met"]) if metrics else None,
        cov=np.asarray(view["cov"]) if cov_words else None,
        timeline=tl,
        tl_dropped=tl_dropped,
        lat_hist=np.asarray(view["lat_hist"]) if latency is not None else None,
        lat_count=np.asarray(view["lat_count"]) if latency is not None else None,
        lat_dropped=np.asarray(view["lat_drop"]) > 0 if latency is not None else None,
        lam=np.asarray(view["lam"]) if causal else None,
    )
