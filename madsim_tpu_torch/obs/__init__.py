"""Observability: reading the engine's observability columns on the host.

Port of the part of ``madsim_tpu/obs`` that the ported taps feed: the
timeline ring's decoder (:mod:`.timeline`), the fleet reductions of the
counters (:mod:`.metrics`, ``metrics=True``, with the causal depth and
width of ``causal=True``) and of the latency sketches (:mod:`.latency`),
causal forensics over a ``causal=True`` ring (:mod:`.causal`: the
backward happens-before cone of a violation) and the Perfetto export of
a decoded timeline (:mod:`.perfetto`). The coverage bitmap
(``cov_words``) is a plain column of the state and of ``SearchReport``.
"""

from .causal import CausalCone, causal_slice, derive_parents, format_cone, parent_class, rederive
from .latency import FleetLatency, fleet_latency, hist_quantile_bucket, latency_reduce
from .metrics import FleetMetrics, fleet_metrics, fleet_reduce
from .perfetto import to_perfetto, write_perfetto
from .timeline import decode_timeline, refold_timeline, timeline_counts

__all__ = [
    "CausalCone",
    "FleetLatency",
    "FleetMetrics",
    "causal_slice",
    "decode_timeline",
    "derive_parents",
    "fleet_latency",
    "fleet_metrics",
    "fleet_reduce",
    "format_cone",
    "hist_quantile_bucket",
    "latency_reduce",
    "parent_class",
    "rederive",
    "refold_timeline",
    "timeline_counts",
    "to_perfetto",
    "write_perfetto",
]
