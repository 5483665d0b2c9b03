"""Observability: reading the engine's observability columns on the host.

Port of the part of ``madsim_tpu/obs`` that the ported taps feed: the
timeline ring's decoder (:mod:`.timeline`) and the fleet reduction of the
latency sketches (:mod:`.latency`). The fleet counters (``metrics=True``)
and the coverage bitmap (``cov_words``) are plain columns of the state
and of ``SearchReport``.
"""

from .latency import FleetLatency, fleet_latency, hist_quantile_bucket, latency_reduce
from .timeline import decode_timeline, refold_timeline, timeline_counts

__all__ = [
    "FleetLatency",
    "decode_timeline",
    "fleet_latency",
    "hist_quantile_bucket",
    "latency_reduce",
    "refold_timeline",
    "timeline_counts",
]
