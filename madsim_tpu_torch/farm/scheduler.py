"""Multi-tenant campaign scheduling over one device set.

Port of ``madsim_tpu/farm/scheduler.py``.

A campaign driver owns the mesh while it runs; a farm serves MANY
hunts — different workloads, spaces and configs — on the same chips.
:func:`run_farm` time-slices N :class:`Tenant` campaigns in
generation-sized quanta, and the whole trick is that both halves of a
tenant switch were already built and certified:

* **preemption is the checkpoint path**: a tenant's slice ends by
  snapshotting its ``CampaignState`` (``persist.CampaignState
  .from_report``) and resumes later through ``resume=`` — the SAME
  splice the save/resume tests pin as bit-identical, because every
  draw is keyed by absolute generation index. A scheduled tenant's
  final corpus/coverage/violations equal its standalone run's,
  whatever the interleaving (test-pinned).
* **switching is compile-free**: the explore generation-program cache
  (``_GEN_CACHE``) keys programs by campaign shape, so each tenant's
  uniform/breed pair is built once and every later slice reuses it —
  retraces == 1 per program key across the whole session,
  profiler-certified (``obs.prof``). Size the cache to the tenant set
  with ``MADSIM_GEN_CACHE_MAX``; eviction counts surface in
  ``flight_summary``.

Slices are awarded round-robin by default (reproducible), or by a
:class:`~.energy.FarmEnergy` power schedule (budget shifts toward
tenants still finding new coverage bits / violations — the
tenant-level AFLFast analogy). All tenants can share one
``obs.FlightRecorder``: the scheduler tags each slice's records with
the tenant name (``FlightRecorder.tagged``), and
``tools/campaign_top.py`` renders the tagged stream as a per-tenant
farm dashboard.
"""

from __future__ import annotations

import dataclasses

from ..explore.device import run_device
from ..explore.persist import CampaignState
from .pipeline import run_pipelined

__all__ = ["FarmReport", "Tenant", "run_farm"]


@dataclasses.dataclass
class Tenant:
    """One farm tenant: a (workload, space, config) campaign plus its
    driver arguments.

    ``generations`` is the tenant's own budget (None = unbounded —
    legal only under a farm-wide ``total_generations``). ``kwargs``
    are passed to the campaign driver verbatim (``invariant``,
    ``batch``, ``root_seed``, ``max_steps``, ``cov_words``, ... —
    everything ``explore.run_device`` takes except ``generations``,
    ``resume`` and ``telemetry``, which the scheduler owns).
    """

    name: str
    wl: object
    cfg: object
    space: object
    generations: int | None = None
    kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FarmReport:
    """Outcome of one scheduled farm session."""

    reports: dict  # tenant name -> final ExploreReport
    schedule: list  # [(slice index, tenant name, generations run)]
    preemptions: dict  # tenant name -> times resumed after preemption
    slices: int

    def banner(self) -> str:
        lines = [
            f"farm: {len(self.reports)} tenants over {self.slices} slices"
        ]
        for name, rep in self.reports.items():
            lines.append(
                f"  {name:<20} {rep.generations:>4} gens | "
                f"{rep.coverage_bits:>5} cov bits | corpus "
                f"{len(rep.corpus):>5} | violations "
                f"{len(rep.violations):>4} | preempted "
                f"{self.preemptions.get(name, 0)}x"
            )
        return "\n".join(lines)


def _tagged_sink(telemetry, name: str):
    if telemetry is None:
        return None
    tagged = getattr(telemetry, "tagged", None)
    if tagged is not None:
        return tagged(name)
    return lambda rec, _s=telemetry, _n=name: _s({**rec, "tenant": _n})


def run_farm(
    tenants,
    *,
    quantum: int = 1,
    total_generations: int | None = None,
    pipeline: bool = False,
    energy=None,
    telemetry=None,
    log=None,
) -> FarmReport:
    """Time-slice ``tenants`` over one device set.

    Each slice runs ONE tenant for up to ``quantum`` generations
    through ``explore.run_device`` (or the pipelined driver with
    ``pipeline=True``), then preempts it via the in-memory
    checkpoint/resume splice. Slices are awarded round-robin in tenant
    declaration order, or by ``energy`` (a :class:`~.energy.FarmEnergy`)
    — a deterministic weighted draw favoring tenants whose last slice
    found new coverage or violations.

    ``total_generations`` caps the farm-wide generation budget (the
    equal-budget knob adaptive-vs-uniform comparisons hold fixed);
    per-tenant ``Tenant.generations`` caps still apply. The session
    ends when every tenant hits its cap or the farm budget runs out.

    A scheduled tenant's outcome is bit-identical to running it
    standalone for the same generation count — the module-docstring
    invariants; the per-tenant ``ExploreReport`` in the returned
    :class:`FarmReport` is the final resumed report (its ``wall_*``
    timers cover the last slice, its corpus/coverage the whole
    campaign).
    """
    tenants = list(tenants)
    if not tenants:
        raise ValueError("run_farm needs at least one tenant")
    names = [t.name for t in tenants]
    if len(set(names)) != len(names):
        raise ValueError(f"tenant names must be unique, got {names}")
    if quantum < 1:
        raise ValueError("need quantum >= 1")
    for t in tenants:
        if t.generations is None and total_generations is None:
            raise ValueError(
                f"tenant {t.name!r} has no generation budget and the farm "
                f"has no total_generations — one bound is required"
            )
        for owned in ("generations", "resume", "telemetry"):
            if owned in t.kwargs:
                raise ValueError(
                    f"tenant {t.name!r} kwargs carry {owned!r}: the "
                    f"scheduler owns it (Tenant docstring)"
                )
    runner = run_pipelined if pipeline else run_device

    states: dict = {t.name: None for t in tenants}
    reports: dict = {}
    done = {t.name: 0 for t in tenants}
    slices_of = {t.name: 0 for t in tenants}
    gains: dict = {}  # name -> (new cov bits, new violations) last slice
    last_cov = {t.name: 0 for t in tenants}
    last_viol = {t.name: 0 for t in tenants}
    schedule: list = []
    total_done = 0
    slice_idx = 0
    cursor = 0  # round-robin position over the declaration order

    def _remaining(t: Tenant) -> int:
        if t.generations is None:
            return total_generations - total_done
        return t.generations - done[t.name]

    while True:
        if total_generations is not None and total_done >= total_generations:
            break
        live = [t for t in tenants if _remaining(t) > 0]
        if not live:
            break
        if energy is not None and energy.active:
            by_name = {t.name: t for t in live}
            t = by_name[energy.pick(slice_idx, [t.name for t in live], gains)]
        else:
            while tenants[cursor % len(tenants)] not in live:
                cursor += 1
            t = tenants[cursor % len(tenants)]
            cursor += 1
        gens = min(quantum, _remaining(t))
        if total_generations is not None:
            gens = min(gens, total_generations - total_done)
        rep = runner(
            t.wl, t.cfg, t.space, generations=gens,
            resume=states[t.name],
            telemetry=_tagged_sink(telemetry, t.name),
            **({"log": log} if log is not None and "log" not in t.kwargs
               else {}),
            **t.kwargs,
        )
        # preemption IS the checkpoint path: snapshot, resume next slice
        states[t.name] = CampaignState.from_report(rep)
        reports[t.name] = rep
        gains[t.name] = (
            rep.coverage_bits - last_cov[t.name],
            len(rep.violations) - last_viol[t.name],
        )
        last_cov[t.name] = rep.coverage_bits
        last_viol[t.name] = len(rep.violations)
        done[t.name] += gens
        total_done += gens
        slices_of[t.name] += 1
        schedule.append((slice_idx, t.name, gens))
        if log is not None:
            log(
                f"farm slice {slice_idx}: {t.name} +{gens} gens "
                f"(done {done[t.name]}, +{gains[t.name][0]} cov bits, "
                f"+{gains[t.name][1]} violations)"
            )
        slice_idx += 1

    return FarmReport(
        reports=reports,
        schedule=schedule,
        preemptions={n: max(s - 1, 0) for n, s in slices_of.items()},
        slices=slice_idx,
    )
