"""Program profiler: per-program build and execute attribution.

Port of ``madsim_tpu/obs/prof.py``. A campaign's wall clock hides very
different costs inside every "dispatch": building the torch program
(the Python closures over the workload, the mutation tables), building
or loading the run kernel's library (nvcc on a cold cache, ``dlopen``
on a warm one), and the execution itself. This module makes the split
a measured quantity, with the JAX package's record schema:

* :class:`AotProgram` — a torch program (an ``explore.device``
  generation, an ``engine.search`` run) made by a function on its first
  call and executed from then on. A build is that function's call plus
  the kernel library it builds or loads: ``trace_s`` is the function's
  Python time, ``lower_s`` is 0 (torch has no lowering stage),
  ``compile_s`` is the library's nvcc or g++ build or its load. Builds
  are counted, so *retraces per cache key* is a counter, not a guess;
  the most recent call's build share is :attr:`AotProgram.last_build_s`
  so drivers can split ``compile_wall_s`` out of their dispatch wall.
  The launch shape of the library (:func:`program_cost`) is recorded at
  build time.
* :class:`ProgramProfiler` — the session registry: enable one
  (:func:`enable` / :func:`profiled`) and every ``AotProgram`` build and
  execution in the process reports into it, giving the campaign-wide
  program table (``report()``) and the retrace certificate
  (``retraces()``). With no profiler active the only overhead is a None
  check per call.
* :func:`device_memory` — the allocator's footprint on the card.
* :func:`count_syncs` — the host's waits for the card inside a block,
  counted by ``torch.profiler`` (the CUDA runtime's synchronisations and
  the device-to-host copies into pageable memory): the measure behind
  a campaign generation's ``host_syncs`` under
  ``explore.device.counted_syncs``.

Everything here is host-side bookkeeping over wall clocks, CUDA events
and built libraries; nothing changes what a program computes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import tempfile
import time
from contextlib import contextmanager

import torch

__all__ = [
    "AotProgram",
    "ProgramProfiler",
    "ProgramRecord",
    "SyncCount",
    "count_syncs",
    "current",
    "device_memory",
    "disable",
    "enable",
    "profiled",
    "program_cost",
]


def digest(key) -> str:
    """Short stable digest of a cache key (any repr-able object)."""
    return hashlib.sha1(repr(key).encode()).hexdigest()[:12]


def program_cost(spec, pool: int, device=0) -> dict:
    """The launch shape of a run-kernel library at ``pool``: lanes per
    seed (``group``), seeds per block, shared bytes per block and
    resident blocks per SM of the run kernel, the drain kernel and the
    run kernel with metrics (the card's occupancy calculator), and the
    registers nvcc reports for each kernel without the taps
    (``registers``). ``spec`` is an ``engine.fused.KernelModel``; it
    needs a card, where the library is built or loaded first."""
    from ..engine.fused import KERNEL, build_library, kernel_registers

    out = dict(KERNEL.occupancy(spec, pool, device))
    out["registers"] = kernel_registers(build_library(spec)[1], pool)
    return out


def device_memory() -> dict:
    """Live device-memory accounting.

    On the card, from ``torch.cuda.memory_stats``: ``live_buffers`` is the
    allocator's live tensor blocks, ``live_buffer_bytes`` the bytes they
    hold and ``allocator_bytes_in_use`` the bytes reserved from the
    driver (the JAX package's key names). Without a card only
    ``live_buffers`` and ``live_buffer_bytes`` are filled, both 0: torch
    keeps no registry of live CPU tensors, so the host view is empty."""
    out = {"live_buffers": 0, "live_buffer_bytes": 0}
    if not torch.cuda.is_available():
        return out
    blocks = used = reserved = 0
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        blocks += int(stats.get("active.all.current", 0))
        used += int(stats.get("active_bytes.all.current", 0))
        reserved += int(stats.get("reserved_bytes.all.current", 0))
    out.update(live_buffers=blocks, live_buffer_bytes=used, allocator_bytes_in_use=reserved)
    return out


@dataclasses.dataclass
class ProgramRecord:
    """One program's accumulated profile (per (name, key))."""

    name: str
    key: str  # cache-key digest — same key twice means a RETRACE
    traces: int = 0  # build events (the retrace counter)
    calls: int = 0
    trace_wall_s: float = 0.0
    lower_wall_s: float = 0.0
    compile_wall_s: float = 0.0
    execute_wall_s: float = 0.0
    # the JAX package's cost fields; the port's builds carry the launch
    # shape instead (ProgramProfiler.events, program_cost), so these stay 0
    flops: float = 0.0
    bytes_accessed: float = 0.0
    arg_bytes: int = 0
    out_bytes: int = 0
    temp_bytes: int = 0
    code_bytes: int = 0

    @property
    def build_wall_s(self) -> float:
        return self.trace_wall_s + self.lower_wall_s + self.compile_wall_s

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ProgramProfiler:
    """Session-wide program registry: builds and executions of every
    :class:`AotProgram` report here while the profiler is active
    (:func:`enable` / :func:`profiled`).

    ``programs`` maps (name, key-digest) to :class:`ProgramRecord`;
    ``pop_events()`` drains the build-event stream (one dict per build,
    in build order) — the flight recorder turns these into ``compile``
    telemetry records and Perfetto instants.
    """

    def __init__(self):
        self.programs: dict = {}
        self.events: list = []
        # (name, key, start, end) CUDA event pairs of calls on the card,
        # read once the card has passed them (:meth:`settle`)
        self._pending: list = []

    def record(self, name: str, key: str) -> ProgramRecord:
        self.settle()
        return self._record(name, key)

    def _record(self, name: str, key: str) -> ProgramRecord:
        rec = self.programs.get((name, key))
        if rec is None:
            rec = self.programs[(name, key)] = ProgramRecord(name, key)
        return rec

    def note_pending(self, name, key, start, end) -> None:
        """A call on the card, timed by the CUDA events ``start`` and
        ``end`` recorded around it: counted now, its device seconds read
        by :meth:`settle`, so the call itself never waits for the card."""
        self._record(name, key).calls += 1
        self._pending.append((name, key, start, end))

    def settle(self) -> None:
        """Fold the device seconds of every pending call into its
        record. An event the card has not passed yet is waited for, with
        torch's sync-debug mode off for the wait (a campaign reads the
        records after its last consume point, when the card has passed
        them all)."""
        pending, self._pending = self._pending, []
        for name, key, start, end in pending:
            if not end.query():
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode(0)
                try:
                    end.synchronize()
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            self._record(name, key).execute_wall_s += start.elapsed_time(end) / 1e3

    def note_build(self, name, key, trace_s, lower_s, compile_s, cost):
        rec = self.record(name, key)
        rec.traces += 1
        rec.trace_wall_s += trace_s
        rec.lower_wall_s += lower_s
        rec.compile_wall_s += compile_s
        self.events.append({
            "program": name, "key": key, "retrace": rec.traces,
            "trace_s": round(trace_s, 4), "lower_s": round(lower_s, 4),
            "compile_s": round(compile_s, 4), **cost,
        })

    def note_execute(self, name, key, seconds):
        rec = self.record(name, key)
        rec.calls += 1
        rec.execute_wall_s += seconds

    def pop_events(self) -> list:
        ev, self.events = self.events, []
        return ev

    def retraces(self, prefix: str = "") -> dict:
        """(name, key) -> build count, optionally filtered by a name
        prefix — the retrace certificate reads this (== 1 per key)."""
        self.settle()
        return {
            nk: rec.traces
            for nk, rec in sorted(self.programs.items())
            if nk[0].startswith(prefix)
        }

    def to_dicts(self) -> list:
        self.settle()
        return [rec.to_dict() for _, rec in sorted(self.programs.items())]

    def report(self) -> str:
        """Text table of every profiled program (the artifact form)."""
        self.settle()
        lines = [
            f"{'program':<28} {'key':<13} {'tr':>3} {'calls':>5} "
            f"{'trace_s':>8} {'lower_s':>8} {'compile_s':>9} {'exec_s':>8} "
            f"{'GFLOP':>8} {'MB_acc':>8} {'MB_tmp':>7}"
        ]
        for _, r in sorted(self.programs.items()):
            lines.append(
                f"{r.name:<28} {r.key:<13} {r.traces:>3} {r.calls:>5} "
                f"{r.trace_wall_s:>8.3f} {r.lower_wall_s:>8.3f} "
                f"{r.compile_wall_s:>9.3f} {r.execute_wall_s:>8.3f} "
                f"{r.flops / 1e9:>8.3f} {r.bytes_accessed / 1e6:>8.1f} "
                f"{r.temp_bytes / 1e6:>7.1f}"
            )
        return "\n".join(lines)


_ACTIVE: ProgramProfiler | None = None


def enable(profiler: ProgramProfiler | None = None) -> ProgramProfiler:
    """Install ``profiler`` (or a fresh one) as the session profiler."""
    global _ACTIVE
    _ACTIVE = profiler if profiler is not None else ProgramProfiler()
    return _ACTIVE


def disable() -> None:
    global _ACTIVE
    _ACTIVE = None


def current() -> ProgramProfiler | None:
    return _ACTIVE


@contextmanager
def profiled(profiler: ProgramProfiler | None = None):
    """Scope a profiler: ``with profiled() as p: ...; p.report()`` —
    restores whatever was active before on exit."""
    global _ACTIVE
    prev = _ACTIVE
    p = enable(profiler)
    try:
        yield p
    finally:
        _ACTIVE = prev


def _cuda_outputs(out) -> bool:
    """Whether a program's output holds a tensor on the card."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_cuda_outputs(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return any(_cuda_outputs(v) for v in out)
    return any(isinstance(v, torch.Tensor) and v.is_cuda
               for v in getattr(out, "__dict__", {}).values())


class AotProgram:
    """A torch program, built once by ``fn()`` on its first call.

    Call it like the program ``fn`` returns. The first call pays the
    build, timed (:attr:`last_build_s` carries the most recent call's
    build share — 0.0 on warm calls, so ``dispatch_wall - last_build_s``
    is pure execution); later calls run the built program directly.
    ``library``, when given, builds or loads the run kernel's library the
    program launches and returns the seconds that took (0.0 when it was
    loaded already): that is the build's ``compile_s``. ``cost``, when
    given, returns the library's launch shape (:func:`program_cost`),
    recorded with the build. ``builds`` counts builds over the program's
    lifetime — the retrace counter the generation-program caches are
    certified by. :attr:`last_compile_s` is the library's share of
    :attr:`last_build_s`. :meth:`build` builds ahead of the call (the
    call then keeps the build's shares).
    """

    def __init__(self, name: str, key, fn, library=None, cost=None):
        self.name = name
        self.key = digest(key)
        self._fn = fn
        self._library = library
        self._cost = cost
        self._prog = None
        self.builds = 0
        self.trace_wall_s = 0.0
        self.lower_wall_s = 0.0
        self.compile_wall_s = 0.0
        self.last_build_s = 0.0
        self.last_compile_s = 0.0
        self.cost: dict = {}
        self._keep = False

    def _build(self):
        t0 = time.perf_counter()  # lint: allow(wall-clock)
        prog = self._fn()
        t1 = time.perf_counter()  # lint: allow(wall-clock)
        compile_s = self._library() if self._library is not None else 0.0
        self._prog = prog
        self.builds += 1
        self.trace_wall_s += t1 - t0
        self.compile_wall_s += compile_s
        self.last_build_s += (t1 - t0) + compile_s
        self.last_compile_s += compile_s
        self.cost = self._cost() if self._cost is not None else {}
        if _ACTIVE is not None:
            _ACTIVE.note_build(self.name, self.key, t1 - t0, 0.0, compile_s, self.cost)
        return prog

    def build(self):
        """Build now unless built; the next call keeps this build's
        shares in :attr:`last_build_s` and :attr:`last_compile_s`."""
        if self._prog is None:
            self.last_build_s = self.last_compile_s = 0.0
            self._build()
            self._keep = True
        return self._prog

    def _program(self):
        if self._keep:
            self._keep = False
            return self._prog
        self.last_build_s = self.last_compile_s = 0.0
        return self._prog if self._prog is not None else self._build()

    def __call__(self, *args, **kw):
        prog = self._program()
        p = _ACTIVE
        if p is None:
            return prog(*args, **kw)
        t0 = time.perf_counter()  # lint: allow(wall-clock)
        start = None
        if torch.cuda.is_available():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        out = prog(*args, **kw)
        if start is not None and _cuda_outputs(out):
            # the device time between two events around the program on
            # its stream, read when the profiler reports: a completion
            # barrier here would be a second wait for the card in every
            # profiled campaign generation
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            p.note_pending(self.name, self.key, start, end)
        else:
            # lint: allow(wall-clock)
            p.note_execute(self.name, self.key, time.perf_counter() - t0)
        return out

    def call_async(self, *args, **kw):
        """``__call__`` without the profiler's completion barrier.

        The profiled ``__call__`` waits for the outputs so
        ``execute_wall_s`` measures device time — which would serialize
        a pipelined schedule right back into the blocking one. This path
        ENQUEUES only (the caller owns the wait at its consume point):
        builds are still timed and counted identically, calls are still
        counted, but the profiler's per-call execute wall is the host's
        enqueue time, with the device wall visible in the caller's
        queue/idle split instead.
        """
        prog = self._program()
        t0 = time.perf_counter()  # lint: allow(wall-clock)
        out = prog(*args, **kw)
        if _ACTIVE is not None:
            # lint: allow(wall-clock)
            _ACTIVE.note_execute(self.name, self.key, time.perf_counter() - t0)
        return out


# ---------------------------------------------------------------------------
# Counting the host's waits for the card.
# ---------------------------------------------------------------------------

# the CUDA runtime and driver calls that block the host until the card
# (a stream, the device, an event) has caught up
_SYNC_RE = re.compile(r"^cu(da)?(Stream|Device|Event|Ctx)Synchronize(_v\d+)?$")
# a synchronous copy call (cudaMemcpy, cuMemcpyDtoH): it waits too
_SYNC_COPY_RE = re.compile(r"^cu(da)?Memcpy(DtoH)?(_v\d+)?$")
# the range count_syncs counts inside (the profiler's own exit waits
# for the card after it)
_MARK = "madsim::count_syncs"


@dataclasses.dataclass
class SyncCount:
    """What :func:`count_syncs` counted inside its block."""

    syncs: int = 0  # CUDA runtime synchronisations (stream, device, event)
    # device-to-host copies into pageable memory, and synchronous copies
    pageable: int = 0
    names: dict = dataclasses.field(default_factory=dict)  # counted name -> n
    measured: bool = False  # False without a card: nothing was counted

    @property
    def total(self) -> int:
        return self.syncs + self.pageable


def _is_pageable_dtoh(event: dict) -> bool:
    """A device-to-host copy into pageable memory, by the copy's kind:
    the activity's name or args name the direction and the host side."""
    text = " ".join([event.get("name", "")] + [
        f"{k}={v}" for k, v in (event.get("args") or {}).items()]).lower()
    dtoh = "dtoh" in text or "device -> pageable" in text or "device_to_host" in text
    return dtoh and "pageable" in text


def _count_trace(trace: dict, out: SyncCount) -> None:
    events = [e for e in trace.get("traceEvents", []) if isinstance(e, dict)]
    # the block's range on the host: the card's annotation of it lasts
    # until the card has run its work, past the host's end, and would
    # take in the profiler's own closing synchronisation
    marks = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("name") == _MARK and "ts" in e
             and str(e.get("cat", "")).lower() != "gpu_user_annotation"]
    if not marks:
        return

    def inside(ts) -> bool:
        return any(lo <= ts <= hi for lo, hi in marks)

    calls = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        cat = str(e.get("cat", "")).lower()
        if corr is not None and cat in ("cuda_runtime", "cuda_driver"):
            calls[corr] = e.get("ts", 0)
    names: dict = {}
    for e in events:
        name = e.get("name", "")
        cat = str(e.get("cat", "")).lower()
        if cat in ("cuda_runtime", "cuda_driver") and inside(e.get("ts", -1)):
            if _SYNC_RE.match(name):
                out.syncs += 1
            elif _SYNC_COPY_RE.match(name):
                out.pageable += 1
            else:
                continue
            names[name] = names.get(name, 0) + 1
        elif "memcpy" in cat or "memcpy" in name.lower():
            if not _is_pageable_dtoh(e):
                continue
            corr = (e.get("args") or {}).get("correlation")
            if corr in calls and not inside(calls[corr]):
                continue
            if corr not in calls and not inside(e.get("ts", -1)):
                continue
            out.pageable += 1
            names[name] = names.get(name, 0) + 1
    out.names = names


@contextmanager
def count_syncs():
    """Count the host's waits for the card inside the block.

    Yields a :class:`SyncCount`, filled when the block ends: ``syncs``,
    the CUDA runtime's stream, device and event synchronisations made
    inside it, and ``pageable``, its device-to-host copies into pageable
    memory (matched by the copy activity's kind) and synchronous
    ``cudaMemcpy`` calls; ``names`` says what was counted. A
    non-blocking copy into pinned memory is not a wait. The block runs
    under ``torch.profiler`` with CPU and CUDA activities; the
    profiler's own synchronisation at its end lies outside the counted
    range, but it does wait for the card, so a block that must not
    wait cannot be timed under it. Without a card nothing is counted
    (``measured`` False)."""
    out = SyncCount()
    if not torch.cuda.is_available():
        yield out
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        with record_function(_MARK):
            yield out
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        p.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
    _count_trace(trace, out)
    out.measured = True
