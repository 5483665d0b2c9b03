"""Failing-schedule shrinking: ddmin over injected fault events.

Port of ``madsim_tpu/chaos/shrink.py``. Each ddmin round is one batched
run through ``make_init`` and ``make_run_while``: on the card, one run
kernel launch and one drain launch; on the CPU, the plain step.

A nemesis search hands back ``(seed, config, plan)`` — but the plan that
*found* a violation usually injects far more chaos than the violation
*needs*. This module delta-debugs the compiled fault trajectory (Zeller
& Hildebrandt's ddmin over plan slots) down to a locally-minimal event
subset that still reproduces the failure, and returns it as a replayable
:class:`~madsim_tpu.chaos.plan.LiteralPlan`.

The batched engine is the whole trick: every ddmin round tests ALL its
candidate subsets as one batch — the same seed replicated B times, each
row with a different validity mask over the plan's pool rows. The batch
is padded to a fixed width, so every round runs the same shape: a
shrink costs a handful of batched runs, not hundreds of single-seed
reruns.

Exact-replay guarantee: candidates keep the full plan's pool layout and
merely invalidate rows, so the minimal subset's trajectory — including
pop-order tie-breaks on equal event times — is identical between the
shrink search and a later ``search_seeds(plan=result.plan)`` replay.
``ShrinkResult.trace`` records the trace hash that replay must (and
does) reproduce.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..engine.convert import field_to_numpy
from ..engine.core import (
    STATE_FIELDS,
    EngineConfig,
    Workload,
    make_init,
    make_run_while,
    resolve_device,
)
from .plan import LiteralPlan

__all__ = ["ShrinkResult", "shrink_plan"]


@dataclasses.dataclass
class ShrinkResult:
    """A locally-minimal failing fault schedule."""

    seed: int
    config_hash: str
    plan: LiteralPlan  # masked literal plan: replays the exact trajectory
    events: tuple  # the enabled (minimal) events, slot order
    trace: int  # uint64 trace hash of the minimal failing run
    rounds: int  # ddmin rounds
    tested: int  # candidate subsets executed
    original_events: int

    def banner(self) -> str:
        lines = [
            f"shrunk seed {self.seed}: {self.original_events} -> "
            f"{len(self.events)} fault event(s) "
            f"({self.rounds} ddmin rounds, {self.tested} candidates)",
            f"  repro: seed={self.seed} config_hash={self.config_hash} "
            f"plan_hash={self.plan.hash()} trace={self.trace:#x}",
        ]
        lines += [f"  {ev}" for ev in sorted(self.events, key=lambda e: e.t)]
        return "\n".join(lines)


def _split(items: list, n: int) -> list[list]:
    """n near-equal contiguous chunks (ddmin's partition)."""
    out, start = [], 0
    for i in range(n):
        end = start + (len(items) - start) // (n - i)
        out.append(items[start:end])
        start = end
    return [c for c in out if c]


def shrink_plan(
    wl: Workload,
    cfg: EngineConfig,
    seed: int,
    plan,
    *,
    invariant=None,
    history_invariant=None,
    max_steps: int = 1000,
    require_halt: bool = False,
    device=None,
    latency=None,
    retry=None,
) -> ShrinkResult:
    """ddmin a failing ``(seed, plan)`` to a minimal fault-event subset.

    ``invariant`` / ``history_invariant`` follow the ``search_seeds``
    contract (view dict / BatchHistory -> per-row bool, True = clean); a
    candidate "still fails" when the predicate flags it on a trustworthy
    run (no pool or history overflow). ``require_halt`` defaults to
    False — unlike a search, a shrink should chase the recorded
    *violation*, not liveness: otherwise removing a fault's healing
    event (a restart, an unclog) strands the run un-halted and ddmin
    happily "minimizes" to a different failure mode. Set it True only
    when shrinking a liveness failure.

    ``device`` is where the runs go, the card unless the caller asks
    for the CPU. A plan with duplication runs with ``dup_rows``.
    ``latency`` (an ``engine.LatencySpec``) runs the tail-latency tap,
    for an invariant that judges the sketch. ``retry`` (an
    ``engine.RetrySpec``) runs the client-retry timers; when None it is
    the plan's own ``retry_spec()``, derived once, so every probe and
    the replay of the shrunk ``LiteralPlan`` (which carries no policy:
    pass the spec to the replay) run under the policy that found the
    violation.

    Raises ValueError if the full plan does not fail on ``seed`` (a
    shrink needs a failing input).
    """
    if invariant is None and history_invariant is None:
        raise ValueError("need an invariant, a history_invariant, or both")
    if history_invariant is not None and wl.history is None:
        raise ValueError(
            f"history_invariant needs histories, but workload {wl.name!r} "
            f"has Workload.history=None"
        )
    seed = int(seed)
    events = plan.compile(seed)
    if not events:
        raise ValueError(f"plan compiles to no events for seed {seed}")
    p = len(events)
    # the candidate batch is padded to a fixed width so ONE compiled
    # program serves every ddmin round (2*granularity <= 2*p candidates)
    b = max(2 * p, 2)
    base = LiteralPlan(events=tuple(events)).compile_batch(
        np.full((b,), seed, np.uint64)
    )
    dup = plan.uses_dup()
    if retry is None and hasattr(plan, "retry_spec"):
        retry = plan.retry_spec()
    init = make_init(wl, cfg, device=resolve_device(device), plan_slots=p, latency=latency,
                     retry=retry)
    run = make_run_while(wl, cfg, max_steps, dup_rows=dup, latency=latency, retry=retry)
    seeds_b = np.full((b,), seed, np.uint64)
    tested = 0

    def _fails(masks: np.ndarray):
        """(nb, p) candidate masks -> (nb,) still-fails + (nb,) traces."""
        nonlocal tested
        nb = masks.shape[0]
        tested += nb
        rows = dataclasses.replace(base, valid=np.zeros((b, p), bool))
        rows.valid[:nb] = masks
        out = run(init(seeds_b, rows))
        view = {f: field_to_numpy(f, getattr(out, f)) for f in STATE_FIELDS}
        ok = (
            np.asarray(invariant(view), bool)
            if invariant is not None
            else np.ones((b,), bool)
        )
        over = view["overflow"] > 0
        if history_invariant is not None:
            from ..check.history import BatchHistory

            bh = BatchHistory.from_view(view)
            over = over | (np.asarray(bh.drop) > 0)
            ok = ok & np.asarray(history_invariant(bh), bool)
        if wl.history is not None:
            over = over | (view["hist_drop"] > 0)
        if require_halt:
            ok = ok & view["halted"]
        fails = ~ok & ~over
        return fails[:nb], view["trace"][:nb]

    full = np.ones((1, p), bool)
    f0, _ = _fails(full)
    if not bool(f0[0]):
        raise ValueError(
            f"seed {seed} does not fail under the full plan "
            f"(plan_hash={plan.hash()}); shrink needs a failing input"
        )

    current = list(range(p))
    granularity = min(2, p)
    rounds = 0
    while len(current) >= 2:
        rounds += 1
        chunks = _split(current, granularity)
        subsets = chunks
        chunk_sets = [set(c) for c in chunks]
        complements = [
            [i for i in current if i not in cs] for cs in chunk_sets
        ]
        cands = subsets + [c for c in complements if c]
        masks = np.zeros((len(cands), p), bool)
        for row, cand in enumerate(cands):
            masks[row, cand] = True
        fails, _ = _fails(masks)
        hit = None
        for row, cand in enumerate(cands):
            if fails[row]:
                hit = (row, cand)
                break
        if hit is not None:
            row, cand = hit
            current = cand
            granularity = 2 if row < len(subsets) else max(granularity - 1, 2)
            granularity = min(granularity, len(current))
        elif granularity < len(current):
            granularity = min(2 * granularity, len(current))
        else:
            break  # 1-minimal at this granularity: done

    mask = np.zeros((p,), bool)
    mask[current] = True
    fails, traces = _fails(mask[None, :])
    assert bool(fails[0]), "ddmin invariant: the kept subset must fail"
    minimal = LiteralPlan(
        events=tuple(events),
        enabled=tuple(bool(x) for x in mask),
        name=f"{getattr(plan, 'name', 'plan')}-shrunk",
    )
    return ShrinkResult(
        seed=seed,
        config_hash=cfg.hash(),
        plan=minimal,
        events=tuple(events[i] for i in current),
        trace=int(traces[0]),
        rounds=rounds,
        tested=tested,
        original_events=p,
    )
