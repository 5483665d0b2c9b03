"""The always-on fuzzing farm (port of ``madsim_tpu/farm``).

One exploration campaign is a blocking Python loop over generations,
and one (workload, space) pair owns the whole device set until it
finishes. The farm turns that single loop into a service-shaped
subsystem, three cooperating layers over the explore drivers:

* **pipelined generations** (:func:`run_pipelined`, farm/pipeline.py) —
  double-buffer ``explore.run_device``: generation g+1's dispatch is
  enqueued before generation g's admission summary, checkpointing and
  flight telemetry are processed on the host, with the one wait (a CUDA
  event behind the summary's pinned copy) at the consume point. The new
  ``queue_wall_s`` / ``idle_wall_s`` split measures the overlap;
  corpus, coverage and violations stay bit-identical to the blocking
  driver (draw keys are addressed by absolute generation index — this
  is a scheduling change, not a semantics change).
* **a campaign scheduler** (:func:`run_farm`, farm/scheduler.py) — N
  :class:`Tenant` (workload, space, config) triples time-sliced over
  one mesh in generation-sized quanta. Preemption is exactly the
  checkpoint/resume path (``CampaignState`` / ``resolve_resume`` —
  already bit-identical across splice points), every tenant's
  generation programs stay resident in the explore ``_GEN_CACHE``
  (retraces == 1 across the whole session, profiler-certified), and
  telemetry streams are tenant-tagged so ``tools/campaign_top.py``
  renders the whole farm.
* **adaptive energy assignment** (:class:`EnergySchedule` /
  :class:`FarmEnergy`, farm/energy.py) — AFLFast-style power schedules
  at two levels: across corpus entries (energy decays with
  times-picked, boosts rare-path coverage and violations) and across
  tenants (budget shifts toward tenants still finding new coverage /
  violations). The uniform schedule is the reproducible default, and
  every energy draw is threefry-keyed under the registered ``farm``
  purpose lane — disjoint from the explore lane, so energy on/off
  never shifts a mutation draw.

On the card, ``chip_smoke.py`` phases 61-63 run the JAX package's
``tools/farm_soak.py`` certificates through this package.
"""

from .energy import EnergySchedule, FarmEnergy  # noqa: F401
from .pipeline import run_pipelined  # noqa: F401
from .scheduler import FarmReport, Tenant, run_farm  # noqa: F401

__all__ = [
    "EnergySchedule",
    "FarmEnergy",
    "FarmReport",
    "Tenant",
    "run_farm",
    "run_pipelined",
]
