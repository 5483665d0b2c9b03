"""Fleet metrics: the engine's MET_* columns reduced where they lie.

Port of ``madsim_tpu/obs/metrics.py``. Every seed folds the MET_*
counters into ``SimState.met`` (``metrics=True``), and this module
reduces the (S, M) batch as torch ops on the tensor's own device —
totals, minima and maxima, log2 histograms, the halt-code distribution
— so a 65,536-seed sweep on the card reports its fleet shape with only
the (M,)- and (M, B)-shaped reductions copied to the host. A causal
run's (S, N) Lamport clocks (``lam=``) fold the same way into the
fleet's causal depth and concurrency width.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..engine.core import (
    HALT_DONE,
    HALT_IDLE,
    HALT_RUNNING,
    HALT_TIME_LIMIT,
    MET_HALT_CODE,
    METRIC_NAMES,
    N_METRICS,
)

__all__ = ["FleetMetrics", "fleet_reduce", "fleet_metrics"]

# log2 histogram buckets: bucket 0 = count 0, bucket b in 1..16 = value
# in [2^(b-1), 2^b), bucket 17 = >= 2^16
N_BUCKETS = 18

_HALT_LABELS = {
    HALT_RUNNING: "running",
    HALT_DONE: "workload-halt",
    HALT_TIME_LIMIT: "time-limit",
    HALT_IDLE: "idle",
}


@dataclasses.dataclass(frozen=True)
class FleetMetrics:
    """Fleet-level reduction of per-seed MET_* counters.

    Every array is indexed by metric slot (``METRIC_NAMES`` order). The
    MET_HALT_CODE slot is categorical, not a counter: its total and mean
    mean nothing, and ``halt_codes`` is the signal there.
    """

    n_seeds: int
    totals: np.ndarray  # (M,) int64 fleet sums
    mins: np.ndarray  # (M,) int32 per-seed minima
    maxs: np.ndarray  # (M,) int32 per-seed maxima
    hist: np.ndarray  # (M, N_BUCKETS) int64 log2 histograms
    halt_codes: np.ndarray  # (4,) int64 seeds per HALT_* code
    # seeds whose event pool dropped events: their counters undercount,
    # so format() names them. 0 when no overflow column was given
    overflowed: int = 0
    # causal stats (fleet_reduce(lam=...)): per-seed max Lamport depth
    # (the longest happens-before chain any node folded) reduced to min,
    # max and a log2 histogram, and the fleet-mean concurrency width
    # sum(lam) / max(lam) (1.0 = sequential, n_nodes = fully
    # concurrent). None without causal columns.
    depth_min: int | None = None
    depth_max: int | None = None
    depth_hist: np.ndarray | None = None  # (N_BUCKETS,) int64
    width_mean: float | None = None

    @property
    def names(self) -> tuple:
        return METRIC_NAMES

    def mean(self, name: str) -> float:
        return float(self.totals[METRIC_NAMES.index(name)]) / self.n_seeds

    def total(self, name: str) -> int:
        return int(self.totals[METRIC_NAMES.index(name)])

    def format(self, histograms: bool = False) -> str:
        """Text table of the fleet shape, the JAX package's rendering."""
        lines = [
            f"fleet metrics over {self.n_seeds} seeds:",
            f"  {'metric':<12} {'total':>12} {'mean':>10} "
            f"{'min':>7} {'max':>7}",
        ]
        for m, name in enumerate(METRIC_NAMES):
            if m == MET_HALT_CODE:
                continue
            lines.append(
                f"  {name:<12} {int(self.totals[m]):>12} "
                f"{self.totals[m] / self.n_seeds:>10.1f} "
                f"{int(self.mins[m]):>7} {int(self.maxs[m]):>7}"
            )
            if histograms:
                nz = np.nonzero(self.hist[m])[0]
                if nz.size:
                    buckets = ", ".join(
                        f"{_bucket_label(b)}: {int(self.hist[m, b])}" for b in nz
                    )
                    lines.append(f"      hist {buckets}")
        halt = ", ".join(
            f"{_HALT_LABELS[c]} {int(self.halt_codes[c])}"
            for c in sorted(_HALT_LABELS)
            if self.halt_codes[c]
        )
        lines.append(f"  halt codes: {halt or 'none'}")
        if self.depth_hist is not None:
            lines.append(
                f"  causal: depth min {self.depth_min} max "
                f"{self.depth_max}, mean concurrency width "
                f"{self.width_mean:.2f}"
            )
            if histograms:
                nz = np.nonzero(self.depth_hist)[0]
                if nz.size:
                    buckets = ", ".join(
                        f"{_bucket_label(b)}: {int(self.depth_hist[b])}" for b in nz
                    )
                    lines.append(f"      depth hist {buckets}")
        if self.overflowed:
            lines.append(
                f"  WARNING: {self.overflowed} seed(s) overflowed the "
                f"event pool — their counters undercount (raise "
                f"pool_size and re-sweep)"
            )
        return "\n".join(lines)


def _bucket_label(b: int) -> str:
    if b == 0:
        return "0"
    if b == N_BUCKETS - 1:
        return f">={1 << (b - 1)}"
    lo, hi = 1 << (b - 1), (1 << b) - 1
    return str(lo) if lo == hi else f"{lo}-{hi}"


def _tensor(x) -> torch.Tensor:
    """A tensor where it lies; numpy (a host copy) as int64 on the CPU,
    uint32 columns widened first."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)


def _log2_hist(v: torch.Tensor) -> torch.Tensor:
    """(..., X) int64 values -> (X, N_BUCKETS) counts over the leading
    axis of the bucket each value falls in."""
    edges = torch.tensor([1 << b for b in range(N_BUCKETS - 1)], device=v.device)
    bucket = (v[..., None] >= edges).sum(-1)
    ids = torch.arange(N_BUCKETS, device=v.device)
    return (bucket[..., None] == ids).sum(0)


def _reduce(met: torch.Tensor) -> tuple:
    """(S, M) int32 -> every fleet reduction, on the tensor's device."""
    m64 = met.to(torch.int64)
    codes = met[:, MET_HALT_CODE]
    halt = (codes[:, None] == torch.arange(4, device=met.device)).sum(0)
    return m64.sum(0), met.min(0).values, met.max(0).values, _log2_hist(m64), halt


def _reduce_lam(lam: torch.Tensor) -> tuple:
    """(S, N) Lamport clocks -> the fleet's causal stats, on the tensor's
    device: per-seed depth = max over nodes, width = sum / max (the
    parallelism ratio), reduced to min, max, histogram and mean."""
    lam = lam.to(torch.int64)
    depth = lam.max(1).values
    total = lam.sum(1)
    # in float64 (torch's true division of ints would round to float32)
    width = torch.where(depth > 0, total.double() / depth.clamp(min=1).double(), 1.0)
    return depth.min(), depth.max(), _log2_hist(depth), width.mean()


def fleet_reduce(met, overflow=None, lam=None) -> FleetMetrics:
    """Reduce an (S, N_METRICS) per-seed metric batch to fleet shape.

    ``met`` may be the ``SimState.met`` tensor on the card (the
    reductions run there and only their results are copied) or a host
    copy (``SearchReport.met``): the same values either way. Pass the
    run's ``overflow`` column too: overflowed seeds' counters undercount,
    and the reduction counts them. ``lam`` is a causal run's (S, N)
    Lamport clocks (``SimState.lam``, ``SearchReport.lam``): the causal
    depth and width fold the same way.
    """
    mm = _tensor(met)
    if mm.dim() != 2 or mm.shape[1] != N_METRICS:
        raise ValueError(
            f"met must be (S, {N_METRICS}) MET_*-slot columns, got shape "
            f"{tuple(mm.shape)}"
        )
    totals, mins, maxs, hist, halt = (x.cpu().numpy() for x in _reduce(mm))
    n_over = 0
    if overflow is not None:
        n_over = int((_tensor(overflow) > 0).sum())
    causal: dict = {}
    if lam is not None and np.prod(tuple(np.shape(lam))):
        dmin, dmax, dhist, wmean = _reduce_lam(_tensor(lam))
        causal = dict(
            depth_min=int(dmin),
            depth_max=int(dmax),
            depth_hist=dhist.cpu().numpy(),
            width_mean=float(wmean),
        )
    return FleetMetrics(
        n_seeds=int(mm.shape[0]),
        totals=totals,
        mins=mins,
        maxs=maxs,
        hist=hist,
        halt_codes=halt,
        overflowed=n_over,
        **causal,
    )


# built (init, run) pairs, the engine.search discipline: repeated fleet
# sweeps over one (workload, config, budget) reuse them
_RUN_CACHE: dict = {}


def fleet_metrics(
    wl,
    cfg,
    n_seeds: int = 4096,
    max_steps: int = 1000,
    seed_base: int = 0,
    seeds=None,
    plan=None,
    device=None,
) -> FleetMetrics:
    """The metrics-only sweep: run ``n_seeds`` schedules on ``device``
    (the card unless the caller asks for the CPU) and return the fleet
    reduction; nothing per-seed is copied to the host, and the history
    and timeline columns are not even allocated (their taps stay off).
    ``plan`` follows the ``search_seeds`` contract (a ``chaos.FaultPlan``
    compiled per seed)."""
    from ..engine.core import make_init, make_run_while, resolve_device

    if seeds is None:
        seeds = np.arange(seed_base, seed_base + n_seeds, dtype=np.uint64)
    else:
        seeds = np.asarray(seeds, np.uint64)
    dev = resolve_device(device)
    plan_slots = int(plan.slots) if plan is not None else 0
    dup = bool(plan.uses_dup()) if plan is not None else False
    key = (id(wl), cfg.hash(), max_steps, str(dev), plan_slots, dup)
    if key not in _RUN_CACHE:
        _RUN_CACHE[key] = (
            make_init(wl, cfg, device=dev, plan_slots=plan_slots, metrics=True),
            make_run_while(wl, cfg, max_steps, dup_rows=dup, metrics=True),
            wl,  # keep the workload alive so id() stays unique
        )
    init, run, _ = _RUN_CACHE[key]
    state = init(seeds, plan.compile_batch(seeds, wl=wl)) if plan is not None else init(seeds)
    out = run(state)
    return fleet_reduce(out.met, overflow=out.overflow)
