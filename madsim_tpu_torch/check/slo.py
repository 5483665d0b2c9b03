"""SLO-violation detection over the engine's latency sketches.

Port of ``madsim_tpu/check/slo.py``, on numpy. A violation is a latency
objective breach: a quantile of the client-observed response time above
a bound, judged per measurement window (``LatencySpec.phases``), so a
fault window that blows the tail shows as its own window's histogram
instead of being diluted over the run.

``slo_bounded`` returns a predicate with the ``search_seeds`` invariant
contract (view dict -> (S,) bool, True = clean). Quantiles live on the
fixed ladder (``engine.LAT_EDGES_NS``), so a seed is flagged only when
the quantile bucket's lower edge exceeds the bound, that is when the
true quantile provably exceeds it: breaches inside the bound's own
bucket are not flagged (under-flag, never false-flag).
``check.device.slo_breaches`` gives the same verdicts as torch ops on
the sketches' own device.
"""

from __future__ import annotations

import numpy as np

from ..engine.core import N_LAT_BUCKETS, lat_bucket_lo

__all__ = ["slo_bounded", "slo_breaches"]


def slo_breaches(
    lat_hist: np.ndarray,
    bound_ns: int,
    q: float = 0.99,
    min_ops: int = 16,
) -> np.ndarray:
    """(S, P, B) sketches -> (S,) True where some window breaches.

    A window is judged only when it completed at least ``min_ops`` ops
    (a one-op window has no p99). The quantile-rank convention is
    ``obs.hist_quantile_bucket``'s."""
    from ..obs.latency import hist_quantile_bucket

    h = np.asarray(lat_hist, np.int64)
    if h.ndim != 3 or h.shape[2] != N_LAT_BUCKETS:
        raise ValueError(
            f"lat_hist must be (S, P, {N_LAT_BUCKETS}), got shape {h.shape}"
        )
    if not 0.0 < q < 1.0:
        raise ValueError(f"q must be in (0, 1), got {q}")
    if min_ops < 1:
        raise ValueError(f"min_ops must be >= 1, got {min_ops}")
    total = h.sum(axis=-1)  # (S, P)
    bucket = hist_quantile_bucket(h, q)  # (S, P), -1 where empty
    # a provable breach: the whole quantile bucket lies above the bound
    lo = lat_bucket_lo(np.clip(bucket, 0, None))
    breach = (total >= min_ops) & (bucket >= 0) & (lo > int(bound_ns))
    return breach.any(axis=-1)


def slo_bounded(
    bound_ns: int,
    q: float = 0.99,
    min_ops: int = 16,
):
    """Build a ``search_seeds`` invariant: every measurement window's
    ``q``-quantile latency stays at or under ``bound_ns``. The sweep
    needs ``latency=LatencySpec(...)``; one without the tap raises
    rather than passing every seed."""

    def invariant(view) -> np.ndarray:
        h = np.asarray(view["lat_hist"])
        if h.ndim != 3 or h.shape[1] == 0 or h.shape[2] == 0:
            raise ValueError(
                "slo_bounded needs latency sketches: run the sweep with "
                "latency=LatencySpec(...) (engine latency tap) and a "
                "client army producing ops"
            )
        return ~slo_breaches(h, bound_ns, q=q, min_ops=min_ops)

    invariant.__name__ = f"slo_p{int(q * 1000)}_le_{int(bound_ns)}ns"
    return invariant
