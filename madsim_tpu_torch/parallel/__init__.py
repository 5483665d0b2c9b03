"""Fleet reductions over seed batches (part of ``madsim_tpu.parallel``).

Only :func:`merge_latency` is here; the seed sharding and the other
merges over ``torch.distributed`` are ROADMAP item A10.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["merge_latency"]


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
