"""Declarative fault plans for the batched engine (port of
``madsim_tpu.chaos``).

* **FaultPlan** (``chaos/plan.py``): composable fault specs (crash and
  pause storms, symmetric, asymmetric and partial partitions, flapping
  partitions, gray-failure slow links, message duplication, clock skew,
  disk-fault windows), compiled per seed with counter-based threefry
  draws keyed ``(seed, plan slot)`` into pre-seeded pool rows
  (``engine.make_init(plan_slots=...)``). ``search_seeds(plan=...)``
  sweeps a plan; ``(seed, config, plan)`` is the repro key.
* **shrink_plan** (``chaos/shrink.py``): ddmin of a failing ``(seed,
  plan)`` to a locally minimal event subset, each round one batched
  run, returned as a replayable ``LiteralPlan``.

Not here yet: ``ClientArmy`` and ``RetryPolicy`` (with the engine's
latency and retry axes), and the asyncio runtime's ``Nemesis``.
"""

from .plan import (  # noqa: F401
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
    SlotTemplate,
    kind_name,
    stack_plan_rows,
)
from .shrink import ShrinkResult, shrink_plan  # noqa: F401

__all__ = [
    "ClockSkew",
    "CrashStorm",
    "DiskFault",
    "Duplicate",
    "FaultEvent",
    "FaultPlan",
    "FlappingPartition",
    "GrayFailure",
    "LiteralPlan",
    "Partition",
    "PauseStorm",
    "ShrinkResult",
    "SlotTemplate",
    "kind_name",
    "shrink_plan",
    "stack_plan_rows",
]
