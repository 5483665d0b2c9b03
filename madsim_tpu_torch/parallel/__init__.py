"""Fleet reductions over seed batches (part of ``madsim_tpu.parallel``).

:func:`merge_metrics` and :func:`merge_latency` fold per-seed columns
into fleet totals on one device; the seed sharding (``make_mesh``,
``shard_map``) and the merges across devices over
``torch.distributed`` are ROADMAP item A10 ("parallel").
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["merge_latency", "merge_metrics"]


def merge_metrics(met) -> np.ndarray:
    """Sum per-seed fleet-metric columns (S, M) into (M,) int64 totals.

    int64 accumulation, so 32-bit per-seed counters cannot overflow the
    fleet sum. The ``MET_HALT_CODE`` slot is summed like any other
    (meaningless as a total; ``obs.fleet_reduce`` gives the halt-code
    split). A tensor is summed on its own device and only the (M,)
    totals reach the host."""
    if isinstance(met, torch.Tensor):
        if met.dim() != 2:
            raise ValueError(f"met must be (S, M), got shape {tuple(met.shape)}")
        return met.to(torch.int64).sum(0).cpu().numpy()
    m = np.asarray(met)
    if m.ndim != 2:
        raise ValueError(f"met must be (S, M), got shape {m.shape}")
    return m.astype(np.int64).sum(axis=0)


def merge_latency(lat_hist) -> np.ndarray:
    """Sum per-seed latency sketches (S, P, B) into (P, B) int64 totals.

    The ladder sketch is exactly mergeable (integer addition), so the
    sum of two halves equals the sum of the whole, bit for bit. A tensor
    is summed on its own device and only the (P, B) totals reach the
    host."""
    if isinstance(lat_hist, torch.Tensor):
        if lat_hist.dim() != 3:
            raise ValueError(f"lat_hist must be (S, P, B), got shape {tuple(lat_hist.shape)}")
        return lat_hist.to(torch.int64).sum(0).cpu().numpy()
    h = np.asarray(lat_hist)
    if h.ndim != 3:
        raise ValueError(f"lat_hist must be (S, P, B), got shape {h.shape}")
    return h.astype(np.int64).sum(axis=0)
