"""Declarative fault plans for the batched engine (port of
``madsim_tpu.chaos``).

* **FaultPlan** (``chaos/plan.py``): composable fault specs (crash and
  pause storms, symmetric, asymmetric and partial partitions, flapping
  partitions, gray-failure slow links, message duplication, clock skew,
  disk-fault windows) and open-loop client load (``ClientArmy``),
  compiled per seed with counter-based threefry
  draws keyed ``(seed, plan slot)`` into pre-seeded pool rows
  (``engine.make_init(plan_slots=...)``). ``search_seeds(plan=...)``
  sweeps a plan; ``(seed, config, plan)`` is the repro key.
* **shrink_plan** (``chaos/shrink.py``): ddmin of a failing ``(seed,
  plan)`` to a locally minimal event subset, each round one batched
  run, returned as a replayable ``LiteralPlan``.

A ``ClientArmy`` may carry a ``RetryPolicy``: the engine then runs its
timeout and backoff re-sends (``FaultPlan.retry_spec()`` is the build
parameter, which ``search_seeds`` and ``shrink_plan`` derive from the
plan).

* **Nemesis** (``chaos/nemesis.py``): the same plan on the single-seed
  runtime, compiled for the runtime's seed into the same event list and
  applied at the same virtual times through ``Handle.kill``/``restart``/
  ``pause``/``resume``, ``NetSim`` (clogs, slow links, duplication),
  ``Handle.set_clock_skew`` and ``FsSim`` (disk faults), so that one
  workload faces one fault trajectory in both execution modes.
"""

from .plan import (  # noqa: F401
    ClientArmy,
    ClockSkew,
    CrashStorm,
    DiskFault,
    Duplicate,
    FaultEvent,
    FaultPlan,
    FlappingPartition,
    GrayFailure,
    LiteralPlan,
    Partition,
    PauseStorm,
    RetryPolicy,
    SlotTemplate,
    kind_name,
    stack_plan_rows,
)
from .nemesis import Nemesis  # noqa: F401
from .shrink import ShrinkResult, shrink_plan  # noqa: F401

__all__ = [
    "ClientArmy",
    "ClockSkew",
    "CrashStorm",
    "DiskFault",
    "Duplicate",
    "FaultEvent",
    "FaultPlan",
    "FlappingPartition",
    "GrayFailure",
    "LiteralPlan",
    "Nemesis",
    "Partition",
    "PauseStorm",
    "RetryPolicy",
    "ShrinkResult",
    "SlotTemplate",
    "kind_name",
    "shrink_plan",
    "stack_plan_rows",
]
