"""madsim_tpu_torch: the batched deterministic simulator on PyTorch.

The port of ``madsim_tpu`` (JAX, TPU) to PyTorch and CUDA on an NVIDIA
H100. It imports neither JAX nor anything of ``madsim_tpu``: what it
needs of that package it keeps as its own copy, and its tests hold it
against the JAX package bit for bit.

* ``engine`` — ``SimState``, ``make_init``, the plain eager step and
  the runners (``make_run``, ``make_run_while``, seed compaction, seed
  search, measurement, the determinism checks, checkpoints and the
  oracle replay); on a CUDA state the runners launch the hand-written
  run kernel (``engine/fused.py``, sources under ``csrc/``).
* ``models`` — the ported workloads (the ``BENCH_SPECS`` and
  ``SOAK_SPECS`` models, their record, bug, chaos-free and army
  variants).
* ``chaos`` — declarative fault plans (``FaultPlan``, ``LiteralPlan``,
  the client army and its retry policy), compiled with numpy or, with
  ``compile_batch(device=True)``, with torch ops on the seeds' device;
  ``shrink_plan``.
* ``check`` — the history checkers and their device screens.
* ``explore`` — coverage-guided exploration: the host driver ``run``,
  the device campaign ``run_device``, mutation, admission and campaign
  checkpoints.
* ``obs`` — the timeline ring's decoder, the latency sketch, causal
  provenance, fleet metrics and Perfetto documents; campaign telemetry
  and ``explain``, the program profiler and the flight recorder.
* ``farm`` — power schedules (``EnergySchedule``, ``FarmEnergy``), the
  pipelined device campaign (``run_pipelined``) and the multi-tenant
  scheduler (``run_farm``).
* ``parallel`` — seed sharding over a ``torch.distributed`` world
  (``make_mesh``, ``shard_state``, ``shard_run_compacted``) and the
  fleet merges, on one device or across the world.
"""

from . import chaos, check, engine, explore, farm, models, obs, parallel  # noqa: F401
