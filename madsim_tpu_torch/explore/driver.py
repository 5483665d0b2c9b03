"""The coverage-guided exploration loop (the AFL shape, batched).

Port of ``madsim_tpu/explore/driver.py``: the host driver. Every
generation is one ``search_seeds(seeds=..., plan_rows=...)`` call, which
on the card launches the run kernel; mutation, admission and the corpus
stay on the host, as in the JAX package.

One campaign = ``generations`` batched sweeps of ``batch`` candidate
``(seed, plan)`` pairs each:

* **generation 0** is the uniform baseline: fresh threefry-derived
  seeds, each running the plan space's FaultPlan exactly as
  ``search_seeds(plan=...)`` would (optionally spiked with
  ``seed_corpus`` literals — targeted hunt knowledge);
* **every later generation** breeds candidates from the corpus:
  parents are picked frontier-first (violating entries before clean
  ones, newest first within each group), each child gets a mutated plan
  (explore/mutate.py) plus either its parent's engine seed (tune the
  fault alignment) or a fresh one, and the whole generation executes
  as ONE batch through ``search_seeds``'s built-run cache — same slot
  count every time, so one (init, run) pair serves the campaign;
* after each generation the on-device admission scan
  (explore/coverage.py) scores every candidate by the bits it newly
  set; entries with fresh coverage (or a violation) join the corpus.

Everything — seeds, mutation draws, parent picks — derives from ONE
root seed via counter-based threefry, so the entire campaign is
replayable: same root, same corpus, same coverage map, same violations,
across runs and across the runners (``compact``). Each violation's
``(root_seed, generation, entry id)`` is a complete repro key; the
entry's stored ``(seed, LiteralPlan)`` replays to the identical trace
hash (:func:`replay_entry`), and feeds ``chaos.shrink_plan`` directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..chaos.plan import (
    FaultEvent,
    FaultPlan,
    LiteralPlan,
    stack_plan_rows,
)
from ..engine.core import KIND_NOP
from ..engine.rng import PURPOSE_EXPLORE, np_threefry2x32v
from ..engine.search import SearchReport, search_seeds
from .coverage import admit, popcount
from .mutate import HostStream, PlanSpace, inherit_threshold, mutate_plan

__all__ = ["CorpusEntry", "ExploreReport", "replay_entry", "run"]


@dataclasses.dataclass
class CorpusEntry:
    """One interesting ``(seed, plan)`` pair.

    ``(root seed, generation, id)`` identifies the entry within its
    campaign; ``(seed, plan)`` + the sweep parameters replay its exact
    trajectory (``trace`` is the hash the replay must reproduce)."""

    id: int
    generation: int
    parent: int  # corpus id of the parent entry; -1 for generation 0
    seed: int  # engine seed (threefry-derived from the root)
    plan: LiteralPlan
    trace: int  # uint64 trace hash of the run
    cov: np.ndarray  # (CW,) uint32 coverage signature
    new_bits: int  # bits this entry set first (admission score)
    violating: bool
    halt_t: int = 0  # halt clock ns (0 = ran to the step cap) — the
    # causal horizon the mutators respect when breeding from this entry


@dataclasses.dataclass
class ExploreReport:
    """Outcome of one exploration campaign."""

    workload: str
    config_hash: str
    plan_hash: str  # the plan space (generation-0 FaultPlan) hash
    root_seed: int
    generations: int  # ABSOLUTE campaign length (resumed runs include
    # the generations a loaded checkpoint already executed)
    batch: int
    max_steps: int
    cov_words: int
    sims: int  # total simulations executed (the budget spent)
    corpus: list  # admitted CorpusEntry list, admission order
    violations: list  # violating CorpusEntry list (also in corpus)
    cov_map: np.ndarray  # (CW,) uint32 final global coverage map
    curve: list  # coverage bits after each generation
    viol_curve: list  # cumulative violation count after each generation
    # next CorpusEntry id — ids are consumed even by entries the full
    # corpus refused, so persist (explore/persist.py) stores it rather
    # than re-deriving from max(id)
    next_id: int = 0
    # whether the campaign's bitmaps used AFL hit-count bucketing
    # (engine cov_hitcount): bucketed and set-only bitmaps are different
    # coordinate systems, so resume refuses a flag mismatch
    cov_hitcount: bool = False
    # per-generation wall split, summed over the campaign: time inside
    # the batched device dispatch vs time the host spent driving it
    # (mutation + admission + corpus bookkeeping on the host driver;
    # the one summary fetch on the device driver). The split is also in
    # every telemetry "generation" record, so the one-host-sync claim
    # of the device driver is measurable from the artifact.
    wall_dispatch_s: float = 0.0
    wall_host_s: float = 0.0
    # trace/lower/compile wall, split OUT of dispatch (historically the
    # first generation's compile was billed to dispatch, skewing
    # warm-vs-cold comparisons): nonzero only on generations that paid
    # a program build — a warmed program cache makes this 0.0 for the
    # whole campaign, which is exactly what the flight recorder
    # certifies
    wall_compile_s: float = 0.0
    # summary-only host synchronization points (explore.run_device: one
    # per generation). 0 = host-driven campaign, where every generation
    # moves per-seed state to the host and the notion does not apply.
    host_syncs: int = 0
    # generations the wall split / host_syncs cover: a RESUMED
    # campaign's timers cover only the resumed run, while
    # ``generations`` counts from generation 0 — the banner pairs
    # syncs against this, not the absolute total
    wall_gens: int = 0
    # pipelined-schedule wall split (farm.run_pipelined): queue =
    # host time spent ENQUEUEING dispatches ahead of the consume point,
    # idle = host time blocked waiting for a generation the device had
    # not finished. Both 0.0 on the blocking drivers — a nonzero split
    # is the measured proof that host-side work (checkpointing,
    # telemetry) overlapped device compute instead of serializing after
    # it. On the pipelined driver wall_dispatch_s == queue + idle.
    wall_queue_s: float = 0.0
    wall_idle_s: float = 0.0

    @property
    def coverage_bits(self) -> int:
        return popcount(self.cov_map)

    def banner(self, limit: int = 5) -> str:
        lines = [
            f"explore over {self.workload!r}: {self.sims} sims "
            f"({self.generations} generations x {self.batch}), root_seed="
            f"{self.root_seed} space={self.plan_hash} "
            f"config_hash={self.config_hash}",
            f"  coverage: {self.coverage_bits} bits "
            f"({self.cov_words * 32} max), corpus {len(self.corpus)} "
            f"entries, curve {self.curve}",
            f"  violations: {len(self.violations)}",
        ]
        if self.wall_dispatch_s or self.wall_host_s:
            total = self.wall_dispatch_s + self.wall_host_s
            frac = self.wall_host_s / total if total else 0.0
            gens = max(self.wall_gens or self.generations, 1)
            compile_note = (
                f" + {self.wall_compile_s:.2f}s compile (cold)"
                if self.wall_compile_s else ""
            )
            if self.host_syncs:
                lines.append(
                    f"  wall: {self.wall_dispatch_s:.2f}s device dispatch "
                    f"+ {self.wall_host_s:.2f}s host sync{compile_note} "
                    f"({frac:.1%} host; {self.host_syncs} summary syncs "
                    f"/ {gens} generations)"
                )
            else:
                lines.append(
                    f"  wall: {self.wall_dispatch_s:.2f}s batched dispatch "
                    f"+ {self.wall_host_s:.2f}s host-driven loop"
                    f"{compile_note} ({frac:.1%} host)"
                )
        if self.wall_queue_s or self.wall_idle_s:
            lines.append(
                f"  pipeline: {self.wall_queue_s:.2f}s enqueue + "
                f"{self.wall_idle_s:.2f}s idle at consume (host work "
                f"overlapped device compute)"
            )
        for e in self.violations[:limit]:
            lines.append(
                f"  violation g{e.generation} id{e.id}: seed {e.seed} "
                f"plan_hash={e.plan.hash()} trace={e.trace:#x}"
            )
        if len(self.violations) > limit:
            lines.append(f"  ... and {len(self.violations) - limit} more")
        return "\n".join(lines)


def _derive_keys(root_seed: int, generation: int, batch: int):
    """Child threefry keys for one generation: key = threefry(root,
    (generation, PURPOSE_EXPLORE + batch-slot)) — the (corpus-id,
    generation, slot) derivation of the design, order-independent
    coordinates like every other stream in the repo."""
    root = np.uint64(root_seed)
    k0 = np.uint32(root & np.uint64(0xFFFFFFFF))
    k1 = np.uint32(root >> np.uint64(32))
    j = np.arange(batch, dtype=np.uint32)
    a, b = np_threefry2x32v(
        k0, k1, np.uint32(generation & 0xFFFFFFFF),
        np.uint32(PURPOSE_EXPLORE) + j,
    )
    return a, b


def _child_seeds(k0s, k1s) -> np.ndarray:
    return k0s.astype(np.uint64) | (k1s.astype(np.uint64) << np.uint64(32))


def _literal_from_rows(rows, j: int, name: str) -> LiteralPlan:
    """Row ``j`` of a compiled PlanRows batch as an exactly-replaying
    LiteralPlan (all slots kept, invalid ones disabled — the
    FaultPlan.literalize layout rule)."""
    time = np.asarray(rows.time)
    kind = np.asarray(rows.kind)
    args = np.asarray(rows.args)
    valid = np.asarray(rows.valid)
    # every in-loop PlanRows source (compile_batch, stack_plan_rows)
    # materializes the node column; None only exists for hand-built
    # rows at the make_init boundary
    node = np.asarray(rows.node)
    events = tuple(
        FaultEvent(
            t=int(time[j, p]), kind=int(kind[j, p]),
            a0=int(args[j, p, 0]), a1=int(args[j, p, 1]),
            node=int(node[j, p]),
        )
        for p in range(time.shape[1])
    )
    return LiteralPlan(
        events=events, enabled=tuple(bool(x) for x in valid[j]), name=name
    )


def _pad_literal(lp: LiteralPlan, slots: int) -> LiteralPlan:
    if lp.slots > slots:
        raise ValueError(
            f"seed-corpus plan {lp.name!r} has {lp.slots} slots; the plan "
            f"space has only {slots}"
        )
    pad = slots - lp.slots
    return LiteralPlan(
        events=tuple(lp.events) + tuple(
            FaultEvent(t=0, kind=KIND_NOP) for _ in range(pad)
        ),
        enabled=tuple(lp._mask()) + (False,) * pad,
        name=lp.name,
    )


def replay_entry(
    wl,
    cfg,
    entry: CorpusEntry,
    *,
    invariant=None,
    history_invariant=None,
    max_steps: int = 1000,
    require_halt: bool = False,
    layout: str | None = None,
    compact: bool = False,
    cov_words: int = 0,
    dup_rows: bool | None = None,
    metrics: bool = False,
    timeline_cap: int = 0,
    latency=None,
    causal: bool = False,
    retry=None,
    device=None,
) -> SearchReport:
    """Re-execute one corpus entry's exact ``(seed, plan)`` pair.

    With the campaign's sweep parameters (``max_steps`` etc.) the
    returned report's trace equals ``entry.trace`` and its verdict
    reproduces the stored violation — the per-entry determinism
    guarantee tests and the soak assert. ``dup_rows`` defaults to what
    the entry's plan needs (the shrink_plan rule) — pass it explicitly
    only to replay under a differently compiled step on purpose.
    ``metrics``/``timeline_cap``/``causal`` turn on the observability
    taps (``obs``) for the replay — the forensics path: derived
    state only, so the replayed trace still equals ``entry.trace``
    (``causal=True`` + ``timeline_cap`` is how a banked violation
    becomes an ``obs.causal_slice`` happens-before cone).

    ``retry``: the ``engine.RetrySpec`` the campaign ran under (the
    hunt derives it from the plan space's ClientArmy policy). A banked
    entry's plan is a LiteralPlan — raw pool rows that no longer carry
    the army's RetryPolicy — so a retried campaign's entries must be
    replayed with the campaign's spec passed explicitly here, or the
    replay runs the fire-and-forget engine and the trace diverges.

    ``layout`` is accepted for the JAX package's signature and changes
    nothing: the port has one lowering of the step. ``device`` is where
    the replay runs (the card unless the caller asks for the CPU).
    """
    del layout
    if dup_rows is None:
        dup_rows = bool(entry.plan.uses_dup())
    if invariant is None and history_invariant is None:
        invariant = lambda view: np.ones(  # noqa: E731 — replay-only
            np.asarray(view["halted"]).shape[0], bool
        )
    return search_seeds(
        wl, cfg, invariant,
        seeds=np.asarray([entry.seed], np.uint64),
        max_steps=max_steps, require_halt=require_halt,
        compact=compact, history_invariant=history_invariant,
        plan_rows=stack_plan_rows([entry.plan]),
        plan_hash=entry.plan.hash(), dup_rows=dup_rows,
        cov_words=cov_words, metrics=metrics, timeline_cap=timeline_cap,
        latency=latency, causal=causal, retry=retry, device=device,
    )


def run(
    wl,
    cfg,
    space,
    *,
    invariant=None,
    history_invariant=None,
    generations: int = 8,
    batch: int = 256,
    root_seed: int = 0,
    max_steps: int = 1000,
    cov_words: int = 32,
    layout: str | None = None,
    compact: bool = False,
    require_halt: bool = False,
    seed_corpus=(),
    select_top: int = 32,
    max_corpus: int = 4096,
    max_ops: int = 3,
    inherit_seed_p: float = 0.75,
    log=None,
    cov_hitcount: bool = False,
    telemetry=None,
    resume=None,
    checkpoint_path: str | None = None,
    latency=None,
    pool_index: bool | None = None,
    energy=None,
    causal: bool = False,
    device=None,
) -> ExploreReport:
    """Run one coverage-guided exploration campaign.

    ``space`` is a :class:`PlanSpace` (or a bare :class:`FaultPlan`,
    wrapped automatically). ``invariant`` / ``history_invariant`` follow
    the ``search_seeds`` contract; ``require_halt`` defaults to False —
    a safety hunt judges the recorded history, not liveness (the
    ``shrink_plan`` rule). ``seed_corpus`` literals (padded to the
    space's slot count) replace the first generation-0 rows: targeted
    hunt knowledge enters the loop as corpus seeds, the greybox-fuzzing
    idiom. ``inherit_seed_p`` is the fraction of children that keep
    their parent's engine seed (tune the fault alignment against a
    fixed protocol trajectory) instead of drawing a fresh one (explore
    seed space). ``log`` (callable, e.g. ``print``) gets one line per
    generation.

    ``cov_hitcount=True`` runs the engine's AFL-style hit-count
    bucketing (make_step docstring): recurrence-magnitude changes
    become fresh coverage, at the cost of a per-seed counter column.

    ``telemetry`` (any callable, e.g. ``list.append``) receives one
    structured record per campaign event: a ``campaign_start``, one
    ``generation`` per generation (coverage bits, corpus size,
    violations, dispatch wall seconds), and a ``campaign_end``.

    ``resume`` (an ``explore.CampaignState`` or a path to one)
    continues a checkpointed campaign: THIS call runs ``generations``
    MORE generations on top of the loaded corpus/coverage/dedup state.
    Draw keys are addressed by absolute generation index, so a resumed
    campaign is bit-identical to the uninterrupted one given the same
    (root seed, batch, space, config) — all validated against the
    checkpoint. ``checkpoint_path`` saves the campaign state after
    every generation (and is the natural ``resume`` input later).

    ``latency`` (an ``engine.LatencySpec``) runs every generation with
    the tail-latency tap on — the SLO hunt: with a ``chaos.ClientArmy``
    in the plan space and ``check.slo_bounded`` as the invariant,
    latency-bucket coverage bits steer the campaign toward schedules
    that move the tail, and p99 breaches are violations like any other
    (dedup, shrink, replay all apply).

    ``energy`` (a ``farm.EnergySchedule``, an AFLFast-style power
    schedule) replaces the uniform frontier pick of each child's parent
    with a weighted draw on the farm lane: the entry's admission score,
    violation and rare-bit bonuses, decayed by its times picked, with
    per-parent seed inheritance. Draw 0 of the explore stream is still
    consumed, so the mutation draws stay at their counters. ``None`` or
    ``EnergySchedule(mode="uniform")`` is the historical uniform
    schedule, bit-identical.

    ``layout`` and ``pool_index`` are accepted for the JAX package's
    signature and change nothing: the port has one lowering of the
    step. ``device`` is where every generation runs (the card unless
    the caller asks for the CPU).

    ``causal=True`` runs every generation with the engine's causal
    columns on, which activates the causal-depth/width coverage
    feature class (make_step feature tag 7): schedules that build
    DEEPER happens-before chains or larger emit-jumps set fresh
    coverage bits, so "more intricate causality" steers the hunt the
    way branch coverage does — and every banked violation replays
    straight into an ``obs.causal_slice`` cone (``replay_entry`` with
    ``causal=True, timeline_cap=...``).
    """
    import time as _time

    del layout, pool_index
    if isinstance(space, FaultPlan):
        space = PlanSpace(space)
    # the army's retry policy is an ENGINE build flag, not plan rows:
    # mutated children are LiteralPlans whose attempt-0 tokens are plain
    # op ids either way, so one spec (the space plan's) serves every
    # generation — and replay_entry must be handed the same spec
    retry = (
        space.plan.retry_spec() if hasattr(space.plan, "retry_spec")
        else None
    )
    if cov_words < 1:
        raise ValueError("exploration needs cov_words >= 1 (the guidance)")
    if generations < 1 or batch < 1:
        raise ValueError("need generations >= 1 and batch >= 1")
    if len(seed_corpus) > batch:
        raise ValueError(
            f"{len(seed_corpus)} seed-corpus plans exceed batch={batch}"
        )
    dup = space.uses_dup()
    # per-campaign mutable energy state (times-picked counters); None
    # means the uniform schedule — the historical, bit-pinned path
    est = energy.state() if energy is not None and energy.active else None
    if resume is not None:
        from .persist import resolve_resume

        st = resolve_resume(resume, wl, space, cfg, root_seed, batch,
                            cov_words, cov_hitcount)
        global_map = np.asarray(st.cov_map, np.uint32).copy()
        corpus = list(st.corpus)
        by_id = {e.id: e for e in corpus}
        violations = list(st.violations)
        seen_viol = {(e.seed, e.trace) for e in violations}
        curve = list(st.curve)
        viol_curve = list(st.viol_curve)
        next_id = st.next_id
        sims = st.sims
        g_start = st.generations_done
    else:
        global_map = np.zeros((cov_words,), np.uint32)
        corpus = []
        by_id = {}
        violations = []
        seen_viol = set()  # (seed, trace) — a violation is counted once
        curve = []
        viol_curve = []
        next_id = 0
        sims = 0
        g_start = 0

    def _snapshot(gens_done: int):
        from .persist import CampaignState

        return CampaignState(
            workload=wl.name, config_hash=cfg.hash(),
            plan_hash=space.hash(), root_seed=int(root_seed), batch=batch,
            cov_words=cov_words, cov_hitcount=cov_hitcount,
            generations_done=gens_done, next_id=next_id, sims=sims,
            curve=list(curve), viol_curve=list(viol_curve),
            cov_map=global_map.copy(), corpus=list(corpus),
            violations=list(violations),
        )

    def _emit(record: dict):
        if telemetry is not None:
            telemetry(record)

    _emit({
        "event": "campaign_start", "workload": wl.name,
        "config_hash": cfg.hash(), "plan_hash": space.hash(),
        "root_seed": int(root_seed), "batch": batch,
        "generations": generations, "cov_words": cov_words,
        "cov_hitcount": cov_hitcount, "resumed_at_generation": g_start,
    })

    wall_dispatch = 0.0
    wall_host = 0.0
    wall_compile = 0.0
    for g in range(g_start, g_start + generations):
        t_gen = _time.monotonic()  # lint: allow(wall-clock)
        k0s, k1s = _derive_keys(root_seed, g, batch)
        seeds = _child_seeds(k0s, k1s)
        overrides: dict[int, LiteralPlan] = {}
        if g == 0 or not corpus:
            # uniform generation: the plan space's own per-seed draws
            # (identical to what search_seeds(plan=space.plan) runs)
            rows = space.plan.compile_batch(seeds, wl=wl)
            plans = None
            parents = [-1] * batch
            if g == 0:
                for j, lp in enumerate(seed_corpus):
                    padded = _pad_literal(lp, space.slots)
                    overrides[j] = padded
                    time = np.asarray(rows.time)
                    time[j] = [e.t for e in padded.events]
                    np.asarray(rows.kind)[j] = [e.kind for e in padded.events]
                    np.asarray(rows.args)[j] = [
                        (e.a0, e.a1) for e in padded.events
                    ]
                    np.asarray(rows.valid)[j] = padded._mask()
                    np.asarray(rows.node)[j] = [
                        e.node for e in padded.events
                    ]
        else:
            # parent pool: violating entries first, NEWEST first — the
            # frontier keeps drifting into fresh trajectory
            # neighborhoods instead of re-mining generation 0 (whose
            # traces the dedup has already seen); the newest
            # non-violating entries fill the remainder (recency over
            # new-bit count won the kvchaos equal-budget measurement)
            order = [
                e.id
                for e in sorted(
                    corpus,
                    key=lambda e: (not e.violating, -e.id),
                )[:select_top]
            ]
            plans = []
            parents = []
            seeds = seeds.copy()
            if est is not None:
                pool, cum = est.pool(corpus, select_top)
            for j in range(batch):
                st = HostStream(int(k0s[j]), int(k1s[j]), PURPOSE_EXPLORE)
                # draw 0 of the explore stream is ALWAYS consumed: under
                # an energy schedule the parent pick moves to the farm
                # lane, but the mutation draws that follow (j >= 2) must
                # stay at the same counters either way
                w0 = st.bits()
                if est is None:
                    pid = order[w0 % len(order)]
                    thresh = inherit_threshold(inherit_seed_p)
                else:
                    pid = est.choose(int(k0s[j]), int(k1s[j]), pool, cum)
                    thresh = est.inherit_threshold(by_id[pid], inherit_seed_p)
                parents.append(pid)
                # inheriting children keep the parent's engine seed:
                # protocol timing stays fixed while the plan mutates,
                # so a near-miss fault alignment can be tuned instead
                # of re-rolled (the rest re-key both, keeping
                # seed-space exploration alive)
                if st.bits() < thresh:
                    seeds[j] = np.uint64(by_id[pid].seed)
                parent = by_id[pid]
                plans.append(
                    mutate_plan(
                        parent.plan, space, st, max_ops=max_ops,
                        name=f"g{g}p{pid}",
                        horizon=parent.halt_t if parent.halt_t > 0 else None,
                    )
                )
            rows = stack_plan_rows(plans)

        t_disp = _time.monotonic()  # lint: allow(wall-clock)
        report = search_seeds(
            wl, cfg, invariant,
            seeds=seeds, max_steps=max_steps, require_halt=require_halt,
            compact=compact,
            history_invariant=history_invariant,
            plan_rows=rows, plan_hash=space.hash(), dup_rows=dup,
            cov_words=cov_words, cov_hitcount=cov_hitcount,
            latency=latency, causal=causal, retry=retry, device=device,
        )
        t_after = _time.monotonic()  # lint: allow(wall-clock)
        # the library build and load share of this dispatch (nonzero
        # only on the library's first use in the process) is billed to
        # compile_wall, NOT dispatch — mixing them skewed every
        # warm-vs-cold generations/s comparison
        compile_wall = report.build_wall_s
        dispatch_wall = (t_after - t_disp) - compile_wall
        sims += batch
        failing = ~report.ok & ~report.overflowed
        # overflowed seeds are quarantined from guidance too: their
        # trajectories dropped events, so their bitmaps are artifacts
        cov_in = np.where(report.overflowed[:, None], np.uint32(0), report.cov)
        new_bits, global_map = admit(cov_in, global_map)
        admitted = 0
        for j in range(batch):
            key = (int(seeds[j]), int(report.traces[j]))
            fresh_viol = bool(failing[j]) and key not in seen_viol
            if not (new_bits[j] > 0 or fresh_viol):
                continue
            if plans is not None:
                plan = plans[j]
            else:
                plan = overrides.get(j) or _literal_from_rows(
                    rows, j, name=f"{space.plan.name}@{int(seeds[j])}"
                )
            entry = CorpusEntry(
                id=next_id, generation=g, parent=parents[j],
                seed=int(seeds[j]), plan=plan,
                trace=int(report.traces[j]), cov=report.cov[j].copy(),
                new_bits=int(new_bits[j]), violating=bool(failing[j]),
                halt_t=int(report.halt_times[j]),
            )
            next_id += 1
            if fresh_viol:
                # a violation is counted once per distinct (seed, trace)
                # trajectory — an inherited-seed child replaying its
                # parent's exact run is a duplicate, not a find
                seen_viol.add(key)
                violations.append(entry)
            if len(corpus) < max_corpus:
                corpus.append(entry)
                by_id[entry.id] = entry
                admitted += 1
        curve.append(popcount(global_map))
        viol_curve.append(len(violations))
        if log is not None:
            log(
                f"explore g{g}: {curve[-1]} coverage bits (+{admitted} "
                f"corpus entries, corpus {len(corpus)}), "
                f"{len(violations)} violations"
            )
        # host-side share of this generation's wall: parent selection,
        # mutation, plan stacking, admission bookkeeping — everything
        # that is NOT the batched dispatch (the split the device driver
        # collapses to one summary sync). mutate/admit are its two
        # measured components (plan breeding before the dispatch,
        # corpus bookkeeping after), so the campaign-Perfetto
        # generation spans can show where the host share goes.
        t_end = _time.monotonic()  # lint: allow(wall-clock)
        mutate_wall = t_disp - t_gen
        admit_wall = t_end - t_after
        host_wall = (t_end - t_gen) - (t_after - t_disp)
        wall_dispatch += dispatch_wall
        wall_host += host_wall
        wall_compile += compile_wall
        _emit({
            "event": "generation", "generation": g, "sims": sims,
            "cov_bits": curve[-1], "new_entries": admitted,
            "corpus_size": len(corpus), "violations": len(violations),
            "dispatch_wall_s": round(dispatch_wall, 3),
            "compile_wall_s": round(compile_wall, 3),
            "mutate_wall_s": round(mutate_wall, 3),
            "admit_wall_s": round(admit_wall, 3),
            "host_wall_s": round(host_wall, 3),
            # pipeline wall split: structurally zero on the host-driven
            # blocking loop (same schema as the pipelined driver)
            "queue_wall_s": 0.0,
            "idle_wall_s": 0.0,
        })
        if checkpoint_path is not None:
            _snapshot(g + 1).save(checkpoint_path)

    _emit({
        "event": "campaign_end", "generations": g_start + generations,
        "generations_run": generations,
        "sims": sims, "cov_bits": curve[-1] if curve else 0,
        "corpus_size": len(corpus), "violations": len(violations),
        "wall_dispatch_s": round(wall_dispatch, 3),
        "wall_host_s": round(wall_host, 3),
        "wall_compile_s": round(wall_compile, 3),
        "wall_queue_s": 0.0,
        "wall_idle_s": 0.0,
    })
    return ExploreReport(
        workload=wl.name,
        config_hash=cfg.hash(),
        plan_hash=space.hash(),
        root_seed=int(root_seed),
        generations=g_start + generations,
        batch=batch,
        max_steps=max_steps,
        cov_words=cov_words,
        sims=sims,
        corpus=corpus,
        violations=violations,
        cov_map=global_map,
        curve=curve,
        viol_curve=viol_curve,
        next_id=next_id,
        cov_hitcount=cov_hitcount,
        wall_dispatch_s=wall_dispatch,
        wall_host_s=wall_host,
        wall_compile_s=wall_compile,
        wall_gens=generations,
    )
