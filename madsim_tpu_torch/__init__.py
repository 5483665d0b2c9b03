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
  ``SOAK_SPECS`` models).
* ``obs`` — the timeline ring's decoder.
"""

from . import engine, models, obs  # noqa: F401
