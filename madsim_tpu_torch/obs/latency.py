"""Fleet tail latency: the reduction of the engine's latency sketches.

Port of ``madsim_tpu/obs/latency.py``. The engine folds every completed
client op into a per-seed ladder histogram (``SimState.lat_hist``,
``make_init(latency=LatencySpec(...))``). This module reduces the
(S, P, B) batch on its own device to the fleet's (P, B) totals, so a
sweep reports its per-window p50/p90/p99/p999 without moving a per-seed
column to the host. The sketch is exactly mergeable: the fleet
histogram equals the histogram of the concatenated per-op latencies.

Quantiles read off the ladder are exact to one bucket of rank error:
``quantile(q)`` returns the upper edge of the bucket the q-th completed
op falls in (about 19% relative width).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..engine.core import N_LAT_BUCKETS, LatencySpec, lat_bucket_hi

__all__ = [
    "FleetLatency",
    "fleet_latency",
    "latency_reduce",
    "hist_quantile_bucket",
]

_QUANTILES = (0.50, 0.90, 0.99, 0.999)


def hist_quantile_bucket(hist, q: float) -> np.ndarray:
    """Bucket index holding the ``q``-quantile of a ladder histogram.

    ``hist`` is (..., N_LAT_BUCKETS); returns int64 bucket indices of the
    same leading shape (-1 where the histogram is empty). The rank is
    ``ceil(q * total)``, the smallest bucket whose cumulative count
    reaches it: the one convention of the sketch, the SLO detector and
    the accuracy tests."""
    h = np.asarray(hist, np.int64)
    total = h.sum(axis=-1)
    rank = np.ceil(q * total).astype(np.int64).clip(min=1)
    cum = np.cumsum(h, axis=-1)
    idx = np.argmax(cum >= rank[..., None], axis=-1)
    return np.where(total > 0, idx, -1)


@dataclasses.dataclass(frozen=True)
class FleetLatency:
    """The fleet's reduction of per-seed latency sketches.

    ``hist`` is the merged (P, B) ladder histogram of every seed's
    completed ops and ``completed`` their count. Quantile values are
    bucket upper edges: the true quantile is at most a bucket width
    below, never above."""

    n_seeds: int
    hist: np.ndarray  # (P, B) int64 merged ladder histogram
    completed: int  # ops folded in
    dropped: int  # markers with out-of-range op ids (fleet sum)
    phase_ns: int  # the windows' width

    @property
    def phases(self) -> int:
        return int(self.hist.shape[0])

    def quantile(self, q: float, phase: int | None = None) -> int:
        """q-quantile latency in ns (bucket upper edge); ``phase=None``
        pools every window. -1 when no op completed there."""
        h = self.hist.sum(axis=0) if phase is None else self.hist[phase]
        b = int(hist_quantile_bucket(h, q))
        return -1 if b < 0 else int(lat_bucket_hi(b))

    def max_ns(self, phase: int | None = None) -> int:
        """Upper edge of the highest occupied bucket (-1 when empty)."""
        h = self.hist.sum(axis=0) if phase is None else self.hist[phase]
        nz = np.nonzero(h)[0]
        return -1 if nz.size == 0 else int(lat_bucket_hi(int(nz[-1])))

    def format(self) -> str:
        """Text table of the fleet's tail, one row per window."""
        lines = [
            f"fleet latency over {self.n_seeds} seeds: "
            f"{self.completed} completed ops"
            + (f", {self.dropped} DROPPED marker(s)" if self.dropped else ""),
            f"  {'window':<10} {'ops':>9} {'p50':>9} {'p90':>9} "
            f"{'p99':>9} {'p999':>9} {'max':>9}",
        ]

        def row(label, h):
            n = int(h.sum())
            cells = []
            for q in _QUANTILES:
                b = int(hist_quantile_bucket(h, q))
                cells.append("-" if b < 0 else f"{int(lat_bucket_hi(b)) / 1e6:.2f}ms")
            nz = np.nonzero(h)[0]
            mx = "-" if nz.size == 0 else f"{int(lat_bucket_hi(int(nz[-1]))) / 1e6:.2f}ms"
            lines.append(
                f"  {label:<10} {n:>9} " + " ".join(f"{c:>9}" for c in cells) + f" {mx:>9}"
            )

        for p in range(self.phases):
            row(f"[{p * self.phase_ns / 1e6:.0f}ms..]", self.hist[p])
        if self.phases > 1:
            row("all", self.hist.sum(axis=0))
        return "\n".join(lines)


def _total(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64).sum(0)


def latency_reduce(lat_hist, lat_count=None, lat_drop=None, *, phase_ns: int) -> FleetLatency:
    """Reduce an (S, P, B) per-seed sketch batch to the fleet's tail.

    ``lat_hist`` may be the state's tensor (summed on its device, and
    only the (P, B) totals copied to the host) or a host array
    (``SearchReport.lat_hist``): the same values, since the merge is
    integer addition. ``phase_ns`` must be the run's
    ``LatencySpec.phase_ns``, which labels the windows."""
    hh = torch.as_tensor(lat_hist)
    if hh.dim() != 3 or hh.shape[2] != N_LAT_BUCKETS:
        raise ValueError(
            f"lat_hist must be (S, P, {N_LAT_BUCKETS}) sketch columns, "
            f"got shape {tuple(hh.shape)}"
        )
    hist = _total(hh).cpu().numpy()
    completed = int(hist.sum()) if lat_count is None else int(_total(lat_count))
    dropped = 0 if lat_drop is None else int(_total(lat_drop))
    return FleetLatency(n_seeds=int(hh.shape[0]), hist=hist, completed=completed,
                        dropped=dropped, phase_ns=int(phase_ns))


def fleet_latency(wl, cfg, spec: LatencySpec, n_seeds: int = 4096, max_steps: int = 1000,
                  seed_base: int = 0, seeds=None, plan=None, device=None) -> FleetLatency:
    """The tail-only sweep: run ``n_seeds`` schedules (``make_run_while``
    with ``latency=spec``, on the card unless the caller asks for the
    CPU) and reduce their sketches on the device; nothing per seed
    reaches the host. ``plan`` follows the ``search_seeds`` contract: for
    a tail profile it composes a ``chaos.ClientArmy`` (the load) with
    the faults the tail is measured under."""
    from ..engine.core import make_init, make_run_while

    if seeds is None:
        seeds = np.arange(seed_base, seed_base + n_seeds, dtype=np.uint64)
    else:
        seeds = np.asarray(seeds, np.uint64)
    slots = int(plan.slots) if plan is not None else 0
    dup = bool(plan.uses_dup()) if plan is not None else False
    init = make_init(wl, cfg, device=device, plan_slots=slots, latency=spec)
    state = init(seeds, plan.compile_batch(seeds, wl=wl)) if plan is not None else init(seeds)
    out = make_run_while(wl, cfg, max_steps, dup_rows=dup, latency=spec)(state)
    return latency_reduce(out.lat_hist, out.lat_count, out.lat_drop, phase_ns=spec.phase_ns)
