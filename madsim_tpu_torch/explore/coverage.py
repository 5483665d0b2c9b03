"""Coverage accounting for the exploration loop.

Port of ``madsim_tpu/explore/coverage.py``. The engine's coverage taps
(``make_init(cov_words=...)``) hand back one AFL-style bitmap per seed:
a set bit is a behavior feature the seed exhibited (a per-node
event-kind transition, a chaos kind in a time phase, a history-record
word). This module turns those per-seed bitmaps into the two
quantities the corpus loop needs:

* **admission** — for each entry of a generation, IN BATCH ORDER, how
  many bits it sets that neither the global map nor any earlier entry of
  the same generation set. Sequential semantics matter: two mutants that
  discover the same new behavior must not both be admitted. The pass is
  an exclusive prefix OR (a log-step scan) and a popcount on the
  bitmaps' own device, so only the (B,) new-bit counts and the merged
  (CW,) map need reach the host.
* **merging / counting** — plain OR-folds and popcounts, used by the
  equal-budget uniform-baseline comparison (the explore soak).

torch has no popcount op: :func:`popcount32` is a SWAR popcount on
uint32 words carried in int64 (the port's rule), shared by every module
of the package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.rng import M32

__all__ = ["admit", "merge", "popcount"]


def popcount(bitmap) -> int:
    """Total set bits of a coverage bitmap (any shape of uint32 words)."""
    words = np.ascontiguousarray(np.asarray(bitmap, np.uint32))
    return int(np.unpackbits(words.view(np.uint8)).sum())


def merge(bitmaps) -> np.ndarray:
    """OR-fold (S, CW) per-seed bitmaps into one (CW,) global map."""
    return np.bitwise_or.reduce(np.asarray(bitmaps, np.uint32), axis=0)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 word carried in an int64 tensor (values
    masked to 32 bits first), elementwise, as int64."""
    x = x & M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    # x < 2**32, so the product stays inside int64
    return ((x * 0x01010101) & M32) >> 24


def prefix_or(rows: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix OR over the leading axis (a log-step scan)."""
    inc = rows
    k = 1
    while k < inc.shape[0]:
        inc = torch.cat([inc[:k], inc[k:] | inc[:-k]])
        k *= 2
    return inc


def admit_torch(cov_batch: torch.Tensor, global_map: torch.Tensor):
    """:func:`admit` on tensors, on their device: ``(new_bits (B,) int64,
    merged (CW,) int64)``, words as uint32 in int64."""
    rows = cov_batch.to(torch.int64) & M32
    gmap = global_map.to(torch.int64) & M32
    if rows.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int64, device=rows.device), gmap
    inc = prefix_or(rows)
    before = torch.cat([torch.zeros_like(inc[:1]), inc[:-1]]) | gmap
    new_bits = popcount32(rows & ~before).sum(1)
    return new_bits, gmap | inc[-1]


def admit(cov_batch, global_map):
    """Sequential-admission pass over one generation.

    ``cov_batch`` is the (B, CW) uint32 bitmaps of the generation in
    batch order; ``global_map`` the (CW,) map before this generation.
    Returns ``(new_bits, merged)``: ``new_bits[j]`` counts bits entry j
    set that neither the global map nor entries 0..j-1 set (the corpus
    keeps entry j iff ``new_bits[j] > 0``), and ``merged`` is the
    global map with the whole generation folded in. Tensors are scanned
    on their device; the results are numpy (int32 counts, uint32 map).
    """
    def as_tensor(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.asarray(x, np.uint32).astype(np.int64))

    rows = as_tensor(cov_batch)
    news, merged = admit_torch(rows, as_tensor(global_map).to(rows.device))
    return (news.cpu().numpy().astype(np.int32),
            merged.cpu().numpy().astype(np.uint32))
