"""Trace comparison: the batched determinism check.

Copy of ``compare_traces`` from ``madsim_tpu/engine/verify.py`` for the
port's states: run the same seeds twice (or on two devices, or through
the kernel and the plain step) and compare the per-seed trace hashes;
any divergence names the first differing seed.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DeterminismError", "compare_traces"]


class DeterminismError(RuntimeError):
    """Raised when two runs that must agree diverge."""


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def compare_traces(a, b, what: str = "run") -> None:
    """Raise :class:`DeterminismError` naming the first seed whose
    traces differ. ``a`` and ``b`` carry ``.trace`` and ``.seed``."""
    ta, tb = _np(a.trace), _np(b.trace)
    if ta.shape != tb.shape:
        raise DeterminismError(
            f"{what}: batch shapes differ ({ta.shape} vs {tb.shape})"
        )
    diff = np.nonzero(ta != tb)[0]
    if diff.size:
        s = int(diff[0])
        seed = int(_np(a.seed).astype(np.int64).view(np.uint64)[s])
        raise DeterminismError(
            f"non-determinism detected in {what}: seed index {s} "
            f"(seed {seed}) produced trace {int(ta[s]) & (2**64 - 1):#x} "
            f"vs {int(tb[s]) & (2**64 - 1):#x}"
        )
