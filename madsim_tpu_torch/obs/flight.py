"""Campaign flight recorder: live telemetry, heartbeats, and the
campaign-level Perfetto export.

Port of ``madsim_tpu/obs/flight.py``. The per-seed observability answers
"what happened inside one simulation"; this module answers the operator
questions about the CAMPAIGN wrapped around thousands of them: where
does wall time go between building programs and kernel libraries,
dispatch and host sync; what device memory does the corpus and seed
batch occupy; and is the multi-hour hunt still making progress *right
now*.

* :class:`FlightRecorder` — wraps any telemetry sink (an
  ``obs.JsonlSink``, a path, or a bare callable) for
  ``explore.run(telemetry=...)`` / ``run_device(telemetry=...)`` and the
  farm. It stamps every record with a sequence number and a
  campaign-relative wall clock, interleaves **heartbeat** records
  (gens/s, coverage growth, ETA, the card's allocator footprint) at a
  configurable cadence, drains the active
  :class:`obs.prof.ProgramProfiler`'s build events into **compile**
  records, and closes the log with a ``flight_summary`` (the full
  program table, memory accounting and the generation-program cache's
  counters). ``profile=True`` (default) enables a session profiler if
  none is active.
* :func:`campaign_perfetto` — renders a campaign's telemetry records (a
  list, or a JSONL path — including the half-written log of a crashed or
  still-running campaign) as trace-event JSON: one span per generation
  with its wall-split sub-slices, counter tracks for coverage bits,
  corpus size, violations and device memory, and compile events as
  instants. It is a pure function of the records: for the same record
  list the document equals the JAX package's.

Every tap is host-side and derived-only: recorder on vs off leaves
corpus, coverage, violations and traces bit-identical across both
drivers, because the drivers only ever *hand records to* the recorder.
"""

from __future__ import annotations

import json
import sys
import time

from . import prof as _prof
from .telemetry import JsonlSink

__all__ = ["FlightRecorder", "campaign_perfetto", "write_campaign_perfetto"]


class FlightRecorder:
    """Telemetry sink wrapper: heartbeats + compile events + summary.

    ``sink`` is a path (opened as a :class:`JsonlSink`, honoring
    ``fsync=``), an open file object, or any callable taking one record
    dict. Pass the recorder itself as the driver's ``telemetry=``.

    ``heartbeat_s`` is the minimum wall gap between heartbeat records
    (0.0 = one after every generation); heartbeats are emitted from
    within the record stream, so they interleave with generation
    records in sequence order and their ``generations_done`` /
    ``t_s`` / ``seq`` fields are monotone by construction.

    ``profile=True`` enables a session :class:`~.prof.ProgramProfiler`
    if none is active (and releases it on :meth:`close`); an already
    active profiler is used as-is and left alone. ``memory=True`` adds
    the live device-memory footprint (:func:`~.prof.device_memory`) to
    heartbeats and the summary.
    """

    def __init__(self, sink, *, heartbeat_s: float = 10.0,
                 profile: bool = True, memory: bool = True,
                 fsync: bool = False):
        if callable(sink) and not hasattr(sink, "write"):
            self._sink = sink
            self._own_sink = False
        else:
            self._sink = JsonlSink(sink, fsync=fsync)
            self._own_sink = True
        self.heartbeat_s = heartbeat_s
        self._memory = memory
        self._seq = 0
        self._t0 = None
        self._last_hb = -float("inf")
        self._gens_target = 0
        self._gens_done = 0
        self._campaign_t0 = 0.0
        self._last_gen: dict = {}
        self._own_profiler = False
        if profile and _prof.current() is None:
            _prof.enable()
            self._own_profiler = True

    # -- the sink protocol ------------------------------------------------
    def __call__(self, record: dict) -> None:
        now = time.monotonic()  # lint: allow(wall-clock)
        if self._t0 is None:
            self._t0 = now
        ev = record.get("event")
        if ev == "campaign_start":
            self._gens_target = int(record.get("generations", 0))
            self._gens_done = 0
            self._campaign_t0 = now
            self._last_hb = now  # first heartbeat after the first gen
        # compile events that happened during the dispatch PRECEDING
        # this record land before it in the log
        p = _prof.current()
        if p is not None:
            for e in p.pop_events():
                self._write({"event": "compile", **e}, now)
        self._write(record, now)
        if ev == "generation":
            self._gens_done += 1
            self._last_gen = record
            if now - self._last_hb >= self.heartbeat_s:
                self._write(self._heartbeat(now), now)
                self._last_hb = now
        elif ev == "campaign_end":
            self._write(self._summary(), now)

    def tagged(self, tenant: str):
        """A per-tenant view of this recorder for farm scheduling.

        The returned callable stamps every record with ``"tenant"``
        before feeding it to the shared recorder, so N scheduled
        campaigns interleave into ONE flight log with one monotone
        ``seq``/``t_s`` spine — heartbeats and the flight summary stay
        farm-wide, and ``tools/campaign_top.py`` splits the stream back
        into per-tenant tables by the tag. Existing ``"tenant"`` keys
        are preserved (re-tagging a tagged stream is a no-op)."""
        def _sink(record: dict, _t=str(tenant)) -> None:
            if "tenant" not in record:
                record = {**record, "tenant": _t}
            self(record)
        return _sink

    def _write(self, record: dict, now: float) -> None:
        rec = dict(record)
        rec["seq"] = self._seq
        rec["t_s"] = round(now - self._t0, 3)
        self._seq += 1
        self._sink(rec)

    def _heartbeat(self, now: float) -> dict:
        wall = max(now - self._campaign_t0, 1e-9)
        rate = self._gens_done / wall
        remaining = max(self._gens_target - self._gens_done, 0)
        hb = {
            "event": "heartbeat",
            "generations_done": self._gens_done,
            "generations": self._gens_target,
            "gens_per_s": round(rate, 4),
            "eta_s": round(remaining / rate, 1) if rate > 0 else None,
            "cov_bits": self._last_gen.get("cov_bits"),
            "corpus_size": self._last_gen.get("corpus_size"),
            "violations": self._last_gen.get("violations"),
        }
        if "tenant" in self._last_gen:
            hb["tenant"] = self._last_gen["tenant"]
        if self._memory:
            hb.update(_prof.device_memory())
        return hb

    def _summary(self) -> dict:
        out: dict = {"event": "flight_summary"}
        p = _prof.current()
        if p is not None:
            out["programs"] = p.to_dicts()
        if self._memory:
            out["memory"] = _prof.device_memory()
        # generation-program cache accounting (LRU size + evictions) —
        # checked via sys.modules so recording a host-only campaign
        # never drags the device driver in
        dev = sys.modules.get("madsim_tpu_torch.explore.device")
        if dev is not None:
            out["gen_cache"] = dev.gen_cache_stats()
        return out

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        if self._own_sink:
            self._sink.close()
        if self._own_profiler:
            _prof.disable()
            self._own_profiler = False

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# campaign-level Perfetto
# ---------------------------------------------------------------------------

_CAMPAIGN_PID = 0
_COUNTERS = ("cov_bits", "corpus_size", "violations")


def _records(source) -> list:
    if isinstance(source, (list, tuple)):
        return list(source)
    out = []
    with open(source) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                # the torn last line of a crashed campaign: everything
                # before it is still a readable flight log
                break
    return out


def _us(t_s: float) -> float:
    return t_s * 1e6


def campaign_perfetto(source, name: str = "campaign") -> dict:
    """Render campaign telemetry as trace-event JSON (ui.perfetto.dev).

    ``source`` is a record list (e.g. captured via
    ``telemetry=records.append``) or a path to a telemetry JSONL — the
    flight recorder's stamped log or a bare ``JsonlSink`` one; a torn
    final line (crashed campaign) is tolerated. The export carries:

    * one ``cat="generation"`` slice per ``generation`` record (span
      count == generation count — the validity pin), with
      mutate/compile/dispatch/admit/sync child slices from whichever
      wall-split keys the driver emitted, in driver order;
    * counter tracks for coverage bits, corpus size, violations (all
      monotone for a healthy campaign) and — when heartbeats carry the
      memory tap — live device-memory bytes and gens/s;
    * ``compile`` records (profiler build events) as instants, and
      heartbeats as counter samples.

    Timestamps come from the flight recorder's ``t_s`` stamps when
    present; records from a bare sink fall back to a cursor summed
    from the wall splits, so the picture is identical up to idle gaps.
    """
    recs = _records(source)
    events: list = []
    wl_name = name
    n_gens = 0
    cursor = 0.0
    for rec in recs:
        ev = rec.get("event")
        if ev == "campaign_start":
            wl_name = rec.get("workload", name)
            driver = rec.get("driver", "host")
            events.append({
                "ph": "i", "cat": "campaign", "s": "g",
                "name": f"campaign_start [{driver}]",
                "pid": _CAMPAIGN_PID, "tid": 0,
                "ts": _us(rec.get("t_s", cursor)),
                "args": {
                    k: v for k, v in rec.items()
                    if isinstance(v, (int, float, str, bool))
                },
            })
            if "t_s" in rec:
                cursor = rec["t_s"]
        elif ev == "generation":
            n_gens += 1
            # sub-span walls in driver order: (host) mutate -> compile
            # -> dispatch -> admit | (device) compile -> dispatch -> sync
            parts = [
                (k.replace("_wall_s", ""), float(rec.get(k, 0.0)))
                for k in ("mutate_wall_s", "compile_wall_s",
                          "dispatch_wall_s", "admit_wall_s", "sync_wall_s")
                if rec.get(k)
            ]
            span = sum(w for _, w in parts)
            # host_wall_s covers mutate+admit plus unmeasured residue;
            # bill the residue so the generation span matches the
            # driver's own accounting
            residue = max(
                float(rec.get("host_wall_s", 0.0))
                - float(rec.get("mutate_wall_s", 0.0))
                - float(rec.get("admit_wall_s", 0.0)),
                0.0,
            )
            span += residue
            end = rec.get("t_s", cursor + span)
            start = max(end - span, 0.0)
            g = rec.get("generation", n_gens - 1)
            events.append({
                "ph": "X", "cat": "generation", "name": f"generation {g}",
                "pid": _CAMPAIGN_PID, "tid": 0,
                "ts": _us(start), "dur": _us(max(span, 1e-6)),
                "args": {
                    k: v for k, v in rec.items()
                    if isinstance(v, (int, float)) and k != "t_s"
                },
            })
            t = start
            for label, w in parts:
                if w <= 0:
                    continue
                events.append({
                    "ph": "X", "cat": "phase", "name": label,
                    "pid": _CAMPAIGN_PID, "tid": 0,
                    "ts": _us(t), "dur": _us(w),
                })
                t += w
            for c in _COUNTERS:
                if c in rec:
                    events.append({
                        "ph": "C", "name": c, "pid": _CAMPAIGN_PID,
                        "tid": 0, "ts": _us(end), "args": {c: rec[c]},
                    })
            cursor = end
        elif ev == "compile":
            events.append({
                "ph": "i", "cat": "compile", "s": "p",
                "name": f"compile {rec.get('program', '?')}",
                "pid": _CAMPAIGN_PID, "tid": 0,
                "ts": _us(rec.get("t_s", cursor)),
                "args": {
                    k: rec[k]
                    for k in ("program", "key", "retrace", "trace_s",
                              "lower_s", "compile_s", "flops",
                              "bytes_accessed")
                    if k in rec
                },
            })
        elif ev == "heartbeat":
            ts = _us(rec.get("t_s", cursor))
            if rec.get("live_buffer_bytes") is not None:
                events.append({
                    "ph": "C", "name": "live_buffer_bytes",
                    "pid": _CAMPAIGN_PID, "tid": 0, "ts": ts,
                    "args": {"live_buffer_bytes": rec["live_buffer_bytes"]},
                })
            if rec.get("gens_per_s") is not None:
                events.append({
                    "ph": "C", "name": "gens_per_s",
                    "pid": _CAMPAIGN_PID, "tid": 0, "ts": ts,
                    "args": {"gens_per_s": rec["gens_per_s"]},
                })
    events.insert(0, {
        "ph": "M", "name": "process_name", "pid": _CAMPAIGN_PID, "tid": 0,
        "args": {"name": f"campaign ({wl_name})"},
    })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"workload": wl_name, "generations": n_gens},
    }


def write_campaign_perfetto(path: str, source, **kw) -> dict:
    """``campaign_perfetto`` + serialize to ``path``; returns the dict."""
    doc = campaign_perfetto(source, **kw)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc
