"""Observability: reading the engine's observability columns on the host.

Port of the part of ``madsim_tpu/obs`` that the ported taps feed: the
timeline ring's decoder (:mod:`.timeline`), the fleet reductions of the
counters (:mod:`.metrics`, ``metrics=True``, with the causal depth and
width of ``causal=True``) and of the latency sketches (:mod:`.latency`),
causal forensics over a ``causal=True`` ring (:mod:`.causal`: the
backward happens-before cone of a violation) and the Perfetto export of
a decoded timeline (:mod:`.perfetto`). The coverage bitmap
(``cov_words``) is a plain column of the state and of ``SearchReport``.

Around the campaigns: :mod:`.telemetry` (``JsonlSink`` and the
per-violation ``explain`` / ``explain_diff`` narratives), :mod:`.prof`
(the program profiler: builds, retraces and execute time of every cached
program, ``device_memory``) and :mod:`.flight` (``FlightRecorder``:
heartbeats, compile records and a closing summary around any telemetry
sink, and ``campaign_perfetto``, a campaign's records as a Perfetto
timeline).
"""

from .causal import CausalCone, causal_slice, derive_parents, format_cone, parent_class, rederive
from .flight import FlightRecorder, campaign_perfetto, write_campaign_perfetto
from .latency import FleetLatency, fleet_latency, hist_quantile_bucket, latency_reduce
from .metrics import FleetMetrics, fleet_metrics, fleet_reduce
from .perfetto import to_perfetto, write_perfetto
from .prof import AotProgram, ProgramProfiler, device_memory
from .telemetry import JsonlSink, explain, explain_diff
from .timeline import decode_timeline, refold_timeline, timeline_counts

__all__ = [
    "AotProgram",
    "CausalCone",
    "FleetLatency",
    "FleetMetrics",
    "FlightRecorder",
    "JsonlSink",
    "ProgramProfiler",
    "campaign_perfetto",
    "causal_slice",
    "decode_timeline",
    "derive_parents",
    "device_memory",
    "explain",
    "explain_diff",
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
    "write_campaign_perfetto",
    "write_perfetto",
]
