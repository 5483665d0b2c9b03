"""Declarative nemesis fault plans, compiled per seed.

Port of ``madsim_tpu/chaos/plan.py``: the fault specs, ``FaultPlan``
and ``LiteralPlan``, compiled with numpy on the host into the engine's
pre-seeded pool rows (``engine.make_init(plan_slots=...)``), the
open-loop client load of a :class:`ClientArmy` among them, with its
optional :class:`RetryPolicy`. Compiles and hashes equal the JAX
package's. ``compile_batch(device=True)`` compiles the same rows with
torch ops on the seeds' device (the device campaigns of
``explore.run_device``), bit-identical to the numpy path.

The reference ecosystem hand-rolls chaos inside each test (a kill here,
a clog there — madsim's tests and every model in madsim_tpu/models did
the same inside their ``on_init``). A :class:`FaultPlan` lifts that into
a declarative layer every workload gets for free: a tuple of composable
fault *specs* — crash-restart storms, pause storms, partitions
(symmetric, asymmetric, partial), gray failures (per-link latency
multipliers), message duplication, per-node clock skew — each of which
compiles, for any seed, into a concrete list of timed fault events.

Randomization is counter-based, exactly like the engine's RNG
(engine/rng.py): every draw is ``threefry2x32(seed, draw-index,
PURPOSE_PLAN + plan-slot)`` — a pure function of its coordinates, so

* each **seed** gets a distinct, exactly reproducible fault trajectory
  (the BatchRNG varying-parameter-stream shape: one logical stream per
  (seed, plan-slot) pair, no serial state anywhere);
* compilation is a vectorized numpy pass over the whole seed batch
  (``compile_batch``), feeding the batched engine's pre-seeded pool rows
  (``engine.make_init(plan_slots=...)``).

``(seed, config, plan)`` is a complete repro key: the plan participates
in the search banner via :meth:`FaultPlan.hash`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import warnings

import numpy as np
import torch

from ..engine.core import (
    FIRST_EXT_KIND,
    FIRST_USER_KIND,
    KIND_CLOG,
    KIND_CLOG_1W,
    KIND_DUP_OFF,
    KIND_DUP_ON,
    KIND_KILL,
    KIND_PAUSE,
    KIND_RESTART,
    KIND_RESUME,
    KIND_SKEW,
    KIND_SLOW_LINK,
    KIND_SYNC_LOSS,
    KIND_SYNC_OK,
    KIND_TORN_OFF,
    KIND_TORN_ON,
    KIND_UNCLOG,
    KIND_UNCLOG_1W,
    KIND_UNSLOW,
    POOL_TILE_CANDIDATES,
    SLOW_MULT_MAX,
    PlanRows,
    RetrySpec,
    _seeds_tensor,
    pack_slow_arg,
    unpack_slow_arg,
)
from ..engine.rng import (
    DRAW_SPAN_MAX,
    M32,
    PURPOSE_CLIENT,
    PURPOSE_PLAN,
    chance_threshold,
    np_threefry2x32v,
    threefry2x32,
)

__all__ = [
    "FaultEvent",
    "FaultPlan",
    "LiteralPlan",
    "SlotTemplate",
    "CrashStorm",
    "PauseStorm",
    "Partition",
    "FlappingPartition",
    "GrayFailure",
    "Duplicate",
    "ClockSkew",
    "DiskFault",
    "ClientArmy",
    "RetryPolicy",
    "kind_name",
    "stack_plan_rows",
]

_KIND_NAMES = {
    KIND_KILL: "kill",
    KIND_RESTART: "restart",
    KIND_PAUSE: "pause",
    KIND_RESUME: "resume",
    KIND_CLOG: "clog",
    KIND_UNCLOG: "unclog",
    KIND_CLOG_1W: "clog-1w",
    KIND_UNCLOG_1W: "unclog-1w",
    KIND_SLOW_LINK: "slow",
    KIND_UNSLOW: "unslow",
    KIND_DUP_ON: "dup-on",
    KIND_DUP_OFF: "dup-off",
    KIND_SKEW: "skew",
    KIND_SYNC_LOSS: "sync-loss",
    KIND_SYNC_OK: "sync-ok",
    KIND_TORN_ON: "torn-on",
    KIND_TORN_OFF: "torn-off",
}


def kind_name(kind: int) -> str:
    return _KIND_NAMES.get(kind, f"kind{kind}")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One concrete injected event: an engine (or, for client-army
    load, user) event at an absolute time. ``node`` is the pool row's
    target — engine kinds ignore it (they act through args), user-kind
    rows (ClientArmy ops) are delivered to it."""

    t: int  # ns from simulation start
    kind: int  # engine / extended-chaos / user kind id
    a0: int = 0
    a1: int = 0
    node: int = 0

    def __str__(self) -> str:
        name = kind_name(self.kind)
        ms = self.t / 1e6
        if FIRST_USER_KIND <= self.kind < FIRST_EXT_KIND:
            # a client-army op: user kind delivered to its target node
            return (
                f"{ms:8.2f}ms client-op user[{self.kind - FIRST_USER_KIND}]"
                f"(id={self.a0}, arg={self.a1}) -> n{self.node}"
            )
        if self.kind in (KIND_SLOW_LINK, KIND_UNSLOW):
            b, mult = unpack_slow_arg(self.a1)
            peer = f"n{b}" if b >= 0 else "*"
            return f"{ms:8.2f}ms {name} n{self.a0}<->{peer} x{max(mult, 1)}"
        if self.kind in (KIND_CLOG, KIND_UNCLOG):
            return f"{ms:8.2f}ms {name} n{self.a0}<->n{self.a1}"
        if self.kind in (KIND_CLOG_1W, KIND_UNCLOG_1W):
            return f"{ms:8.2f}ms {name} n{self.a0}->n{self.a1}"
        if self.kind == KIND_SKEW:
            return f"{ms:8.2f}ms {name} n{self.a0} {self.a1}ns"
        if self.kind in (KIND_DUP_ON, KIND_DUP_OFF):
            return f"{ms:8.2f}ms {name}"
        return f"{ms:8.2f}ms {name} n{self.a0}"


# ---------------------------------------------------------------------------
# counter-based plan randomness. One implementation, two array backends:
# numpy seeds compile on the host (the default path), a torch tensor of
# seeds compiles with torch ops on its own device (the device path of
# the explore campaigns). Both run the identical threefry and reduction
# arithmetic, so the two paths are bit-identical (tests pin it).
# ---------------------------------------------------------------------------


class _Stream:
    """The (seed, plan-slot) draw stream: ``bits(j)`` is draw j of this
    slot for every seed at once — order-independent coordinates, same
    discipline as the engine's per-event draws.

    Seeds are numpy uint64 (draws are uint32 arrays) or an int64 tensor
    of uint64 bit patterns (draws are uint32 words in int64 tensors on
    the seeds' device: the high word is masked after the arithmetic
    shift)."""

    def __init__(self, seeds, slot: int, purpose: int = PURPOSE_PLAN):
        self.dev = seeds.device if isinstance(seeds, torch.Tensor) else None
        if self.dev is not None:
            seeds = seeds.to(torch.int64)
            self._k0 = seeds & M32
            self._k1 = (seeds >> 32) & M32
            self._x1 = (purpose + slot) & M32
            return
        seeds = np.asarray(seeds, np.uint64)
        self._k0 = (seeds & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        self._k1 = (seeds >> np.uint64(32)).astype(np.uint32)
        self._x1 = np.uint32((purpose + slot) & 0xFFFFFFFF)

    def bits(self, j: int):
        if self.dev is not None:
            return threefry2x32(self._k0, self._k1, j, self._x1)[0]
        a, _ = np_threefry2x32v(self._k0, self._k1, np.uint32(j), self._x1)
        return a

    def mod(self, j: int, n: int):
        """Draw j reduced modulo ``n`` (< 2**32), as int64."""
        if self.dev is not None:
            return self.bits(j) % int(n)
        return (self.bits(j) % np.uint32(n)).astype(np.int64)

    def uniform(self, lo: int, hi: int, j: int):
        """Uniform int64 in [lo, hi) — the engine's modulo reduction."""
        span = max(int(hi) - int(lo), 1)
        if self.dev is not None:
            return int(lo) + self.mod(j, span)
        return np.int64(lo) + self.mod(j, span)

    def options(self, options):
        """A target tuple as an int64 array on the stream's backend. On
        the card it crosses from pinned memory without a wait, so a
        compile enqueued behind running work does not wait for it."""
        if self.dev is not None:
            host = torch.tensor(options, dtype=torch.int64)
            if self.dev.type == "cuda":
                host = host.pin_memory()
            return host.to(self.dev, non_blocking=True)
        return np.asarray(options, np.int64)

    def pick(self, options, j: int):
        return self.options(options)[self.mod(j, len(options))]

    def where(self, cond, a, b):
        """``where(cond, a, b)`` as int64 on the stream's backend."""
        if self.dev is not None:
            return torch.where(cond, a, b).to(torch.int64)
        return np.where(cond, a, b).astype(np.int64)

    def chance(self, p: float, j: int):
        thresh = chance_threshold(p)
        if thresh >= (1 << 32):
            if self.dev is not None:
                return torch.ones(self._k0.shape, dtype=torch.bool, device=self.dev)
            return np.ones(self._k0.shape, bool)
        return self.bits(j) < thresh


# ---------------------------------------------------------------------------
# fault specs
# ---------------------------------------------------------------------------


def _pack_slots(s: int, rows, dev=None):
    """Stack per-slot ``(time, kind, a0, a1, valid[, node])`` rows into
    the (S, P[, 2]) column arrays ``compile_batch`` returns. Scalars
    broadcast over the seed axis. The optional sixth entry is the pool
    row's target node (a client-army op's); absent, node 0, which engine
    kinds ignore. With ``dev`` (a torch device) the columns are tensors
    there."""
    if dev is not None:
        return _pack_slots_torch(s, rows, dev)

    def col(v, dtype):
        a = np.asarray(v, dtype)
        if a.ndim == 0:
            a = np.broadcast_to(a, (s,))
        return a.astype(dtype)

    time = np.stack([col(r[0], np.int64) for r in rows], axis=1)
    kind = np.stack([col(r[1], np.int32) for r in rows], axis=1)
    a0 = np.stack([col(r[2], np.int32) for r in rows], axis=1)
    a1 = np.stack([col(r[3], np.int32) for r in rows], axis=1)
    valid = np.stack([col(r[4], np.bool_) for r in rows], axis=1)
    node = np.stack([col(r[5] if len(r) > 5 else 0, np.int32) for r in rows], axis=1)
    return time, kind, np.stack([a0, a1], axis=2), valid, node


def _pack_slots_torch(s: int, rows, dev):
    def col(v, dtype):
        if isinstance(v, torch.Tensor):
            return v.to(dtype).expand(s) if v.dim() == 0 else v.to(dtype)
        return torch.full((s,), int(v), dtype=dtype, device=dev)

    time = torch.stack([col(r[0], torch.int64) for r in rows], dim=1)
    kind = torch.stack([col(r[1], torch.int32) for r in rows], dim=1)
    a0 = torch.stack([col(r[2], torch.int32) for r in rows], dim=1)
    a1 = torch.stack([col(r[3], torch.int32) for r in rows], dim=1)
    valid = torch.stack([col(r[4], torch.bool) for r in rows], dim=1)
    node = torch.stack([col(r[5] if len(r) > 5 else 0, torch.int32) for r in rows], dim=1)
    return time, kind, torch.stack([a0, a1], dim=2), valid, node


@dataclasses.dataclass(frozen=True)
class SlotTemplate:
    """Mutation metadata for ONE plan slot (the madsim_tpu.explore
    hook): the window a retimed event may land in, the node set a
    retargeted event may hit, and how its args word is drawn. Specs
    expose one template per slot via ``slot_templates()`` so the
    exploration mutators can perturb a compiled plan without knowing
    any spec's internals."""

    kind: int  # the slot's event kind
    t_min_ns: int  # retime/add draw window (absolute ns)
    t_max_ns: int
    targets: tuple = ()  # candidate nodes (empty = args not node-valued)
    # how retarget draws the args: "node" (a0 = one target), "pair"
    # (a0, a1 = two distinct targets — clog/unclog edges), "slow"
    # (a0 = node, a1 = pack_slow_arg(peer, mult)), "skew" (a0 = node,
    # a1 = skew ns), "none" (args fixed, e.g. dup toggles)
    arg_kind: str = "node"
    mult_min: int = 1
    mult_max: int = 1
    skew_min_ns: int = 0
    skew_max_ns: int = 0


def _check_window(lo: int, hi: int, what: str) -> None:
    if not 0 <= lo <= hi:
        raise ValueError(f"{what} window [{lo}, {hi}] is invalid")
    # draws are 32-bit (the engine's reduction discipline): a span that
    # doesn't fit uint32 would wrap/overflow in _Stream.uniform — the
    # same DRAW_SPAN_MAX contract EngineConfig enforces on its latency
    # ranges and the absint range contracts assume (engine/rng.py owns
    # the constant, so this validator and the prover cannot drift)
    if hi - lo > DRAW_SPAN_MAX:
        raise ValueError(
            f"{what} span {hi - lo} ns does not fit uint32 "
            f"(max {DRAW_SPAN_MAX} ns, ~4.29 s)"
        )


@dataclasses.dataclass(frozen=True)
class CrashStorm:
    """``n`` kill/restart pairs: each kill hits a random target node at a
    random time in [t_min, t_max) and the victim restarts after a random
    downtime in [down_min, down_max). Kills may overlap (two victims down
    at once) — exactly the storm shape a majority protocol must survive."""

    targets: tuple
    n: int = 1
    t_min_ns: int = 20_000_000
    t_max_ns: int = 400_000_000
    down_min_ns: int = 50_000_000
    down_max_ns: int = 400_000_000

    def __post_init__(self):
        if not self.targets:
            raise ValueError("CrashStorm needs at least one target node")
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        _check_window(self.t_min_ns, self.t_max_ns, "kill-time")
        _check_window(self.down_min_ns, self.down_max_ns, "downtime")

    _KIND_ON = KIND_KILL
    _KIND_OFF = KIND_RESTART

    @property
    def slots(self) -> int:
        return 2 * self.n

    def compile_batch(self, seeds, slot: int):
        st = _Stream(seeds, slot)
        rows = []
        for i in range(self.n):
            who = st.pick(self.targets, 3 * i)
            at = st.uniform(self.t_min_ns, self.t_max_ns, 3 * i + 1)
            down = st.uniform(self.down_min_ns, self.down_max_ns, 3 * i + 2)
            rows.append((at, self._KIND_ON, who, 0, True))
            rows.append((at + down, self._KIND_OFF, who, 0, True))
        return _pack_slots(len(seeds), rows, st.dev)

    def slot_templates(self) -> tuple:
        out = []
        for _ in range(self.n):
            out.append(SlotTemplate(
                kind=self._KIND_ON, t_min_ns=self.t_min_ns,
                t_max_ns=self.t_max_ns, targets=self.targets,
            ))
            out.append(SlotTemplate(
                kind=self._KIND_OFF,
                t_min_ns=self.t_min_ns + self.down_min_ns,
                t_max_ns=self.t_max_ns + self.down_max_ns,
                targets=self.targets,
            ))
        return tuple(out)



@dataclasses.dataclass(frozen=True)
class PauseStorm(CrashStorm):
    """CrashStorm's non-destructive sibling: pause/resume instead of
    kill/restart — the victim keeps its state and its pending events are
    held, the classic long-GC-stall fault."""

    _KIND_ON = KIND_PAUSE
    _KIND_OFF = KIND_RESUME


@dataclasses.dataclass(frozen=True)
class Partition:
    """One network cut: a random nonempty proper subset of ``targets``
    is separated from the rest at a random time and healed after a
    random duration.

    ``asymmetric=True`` clogs each cut edge in ONE random direction only
    (messages flow the other way — the split-brain-inducing half-open
    failure). ``partial_p < 1`` clogs each edge only with that
    probability (a partial partition: some paths across the cut
    survive, routing around the damage stays possible)."""

    targets: tuple
    t_min_ns: int = 20_000_000
    t_max_ns: int = 400_000_000
    dur_min_ns: int = 50_000_000
    dur_max_ns: int = 400_000_000
    asymmetric: bool = False
    partial_p: float = 1.0

    def __post_init__(self):
        if len(self.targets) < 2:
            raise ValueError("Partition needs at least two target nodes")
        if len(self.targets) > 30:
            raise ValueError("Partition subset draw supports <= 30 targets")
        if not 0.0 < self.partial_p <= 1.0:
            raise ValueError(f"partial_p must be in (0, 1], got {self.partial_p}")
        _check_window(self.t_min_ns, self.t_max_ns, "cut-time")
        _check_window(self.dur_min_ns, self.dur_max_ns, "cut-duration")

    @property
    def slots(self) -> int:
        t = len(self.targets)
        return 2 * (t * (t - 1) // 2)

    def compile_batch(self, seeds, slot: int):
        st = _Stream(seeds, slot)
        t = len(self.targets)
        full = (1 << t) - 1
        # nonempty proper subset: remap 32 uniform bits into [1, full-1]
        side = 1 + st.mod(0, full - 1)
        at = st.uniform(self.t_min_ns, self.t_max_ns, 1)
        dur = st.uniform(self.dur_min_ns, self.dur_max_ns, 2)
        rows = _partition_edge_rows(
            st, self.targets, self.asymmetric, self.partial_p,
            side, at, dur, 3,
        )
        return _pack_slots(len(seeds), rows, st.dev)

    def slot_templates(self) -> tuple:
        return _partition_slot_templates(
            self.targets, self.asymmetric,
            self.t_min_ns, self.t_max_ns, self.dur_min_ns, self.dur_max_ns,
        )



def _partition_edge_rows(st, targets, asymmetric, partial_p,
                         side, at, dur, draw0):
    """Per-edge clog/unclog slot rows of one cut — shared by Partition
    (one cut per plan) and FlappingPartition (one call per cycle).
    Edge q draws its word at ``draw0 + q``."""
    t = len(targets)
    clog_k = KIND_CLOG_1W if asymmetric else KIND_CLOG
    unclog_k = KIND_UNCLOG_1W if asymmetric else KIND_UNCLOG
    rows = []
    q = 0
    for i in range(t):
        for j in range(i + 1, t):
            word = st.bits(draw0 + q)
            crosses = ((side >> i) & 1) != ((side >> j) & 1)
            keep = crosses
            if partial_p < 1.0:
                keep = keep & ((word & 0xFFFF) < int(partial_p * 0x10000))
            # asymmetric: bit 16 of the edge word picks the blocked
            # direction (independent of the partial-keep low bits)
            fwd = ((word >> 16) & 1) != 0
            pick_fwd = fwd | (not asymmetric)
            a = st.where(pick_fwd, targets[i], targets[j])
            b = st.where(pick_fwd, targets[j], targets[i])
            rows.append((at, clog_k, a, b, keep))
            rows.append((at + dur, unclog_k, a, b, keep))
            q += 1
    return rows


def _partition_slot_templates(targets, asymmetric, t_min, t_max,
                              dur_min, dur_max) -> tuple:
    t = len(targets)
    clog_k = KIND_CLOG_1W if asymmetric else KIND_CLOG
    unclog_k = KIND_UNCLOG_1W if asymmetric else KIND_UNCLOG
    out = []
    for _ in range(t * (t - 1) // 2):
        out.append(SlotTemplate(
            kind=clog_k, t_min_ns=t_min, t_max_ns=t_max,
            targets=targets, arg_kind="pair",
        ))
        out.append(SlotTemplate(
            kind=unclog_k, t_min_ns=t_min + dur_min, t_max_ns=t_max + dur_max,
            targets=targets, arg_kind="pair",
        ))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FlappingPartition:
    """Route instability: ``n_cycles`` cut/heal cycles, each cutting a
    FRESHLY drawn nonempty proper subset of ``targets`` — sides AND
    timing re-randomize every cycle, the flapping-route failure a
    single :class:`Partition` cut cannot express. Cycle 0 cuts at a
    random time in [t_min, t_max); every cut holds for a duration in
    [dur_min, dur_max) and the next cut follows the heal after a gap in
    [up_min, up_max). ``asymmetric``/``partial_p`` apply per cycle,
    exactly as in :class:`Partition`."""

    targets: tuple
    n_cycles: int = 2
    t_min_ns: int = 20_000_000
    t_max_ns: int = 400_000_000
    dur_min_ns: int = 50_000_000
    dur_max_ns: int = 300_000_000
    up_min_ns: int = 20_000_000
    up_max_ns: int = 200_000_000
    asymmetric: bool = False
    partial_p: float = 1.0

    def __post_init__(self):
        if len(self.targets) < 2:
            raise ValueError("FlappingPartition needs at least two target nodes")
        if len(self.targets) > 30:
            raise ValueError(
                "FlappingPartition subset draw supports <= 30 targets"
            )
        if self.n_cycles < 1:
            raise ValueError(f"n_cycles must be >= 1, got {self.n_cycles}")
        if not 0.0 < self.partial_p <= 1.0:
            raise ValueError(
                f"partial_p must be in (0, 1], got {self.partial_p}"
            )
        _check_window(self.t_min_ns, self.t_max_ns, "first-cut-time")
        _check_window(self.dur_min_ns, self.dur_max_ns, "cut-duration")
        _check_window(self.up_min_ns, self.up_max_ns, "heal-gap")

    @property
    def _edges(self) -> int:
        t = len(self.targets)
        return t * (t - 1) // 2

    @property
    def slots(self) -> int:
        return self.n_cycles * 2 * self._edges

    def compile_batch(self, seeds, slot: int):
        st = _Stream(seeds, slot)
        t = len(self.targets)
        full = (1 << t) - 1
        rows = []
        heal = None
        # each cycle's draw block: side, duration, start-offset, then
        # one word per edge — appending a cycle never re-randomizes the
        # ones before it (the spec-offset rule applied within the spec)
        block = 3 + self._edges
        for c in range(self.n_cycles):
            base = c * block
            side = 1 + st.mod(base, full - 1)
            dur = st.uniform(self.dur_min_ns, self.dur_max_ns, base + 1)
            if c == 0:
                at = st.uniform(self.t_min_ns, self.t_max_ns, base + 2)
            else:
                at = heal + st.uniform(self.up_min_ns, self.up_max_ns, base + 2)
            rows += _partition_edge_rows(
                st, self.targets, self.asymmetric, self.partial_p,
                side, at, dur, base + 3,
            )
            heal = at + dur
        return _pack_slots(len(seeds), rows, st.dev)

    def slot_templates(self) -> tuple:
        out = []
        for c in range(self.n_cycles):
            # cycle c's cut lands after c earlier (duration + gap) spans
            lo = self.t_min_ns + c * (self.dur_min_ns + self.up_min_ns)
            hi = self.t_max_ns + c * (self.dur_max_ns + self.up_max_ns)
            out += _partition_slot_templates(
                self.targets, self.asymmetric, lo, hi,
                self.dur_min_ns, self.dur_max_ns,
            )
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class GrayFailure:
    """``n_links`` random links turn slow (latency x mult in
    [mult_min, mult_max]) for a random window — the gray failure of the
    runtime-variability literature: nothing is *down*, some paths are
    just an order of magnitude slower, which readiness-oblivious
    protocols mistake for loss and retry into."""

    targets: tuple
    n_links: int = 1
    t_min_ns: int = 20_000_000
    t_max_ns: int = 400_000_000
    dur_min_ns: int = 50_000_000
    dur_max_ns: int = 400_000_000
    mult_min: int = 4
    mult_max: int = 32

    def __post_init__(self):
        if len(self.targets) < 2:
            raise ValueError("GrayFailure needs at least two target nodes")
        if self.n_links < 1:
            raise ValueError(f"n_links must be >= 1, got {self.n_links}")
        if not 1 <= self.mult_min <= self.mult_max:
            raise ValueError(
                f"multiplier range [{self.mult_min}, {self.mult_max}] invalid"
            )
        if self.mult_max > SLOW_MULT_MAX:
            # engine.SLOW_MULT_MAX owns the packed-args-word bound AND
            # the absint slow-column range contract: one declaration
            raise ValueError(
                f"multiplier must fit the packed args word "
                f"(engine.SLOW_MULT_MAX = {SLOW_MULT_MAX})"
            )
        _check_window(self.t_min_ns, self.t_max_ns, "slow-time")
        _check_window(self.dur_min_ns, self.dur_max_ns, "slow-duration")

    @property
    def slots(self) -> int:
        return 2 * self.n_links

    def compile_batch(self, seeds, slot: int):
        st = _Stream(seeds, slot)
        t = len(self.targets)
        opts = st.options(self.targets)
        rows = []
        for i in range(self.n_links):
            ai = st.mod(5 * i, t)
            # peer drawn from the other t-1 targets: a != b always
            bi = (ai + 1 + st.mod(5 * i + 1, t - 1)) % t
            a = opts[ai]
            b = opts[bi]
            at = st.uniform(self.t_min_ns, self.t_max_ns, 5 * i + 2)
            dur = st.uniform(self.dur_min_ns, self.dur_max_ns, 5 * i + 3)
            mult = st.uniform(self.mult_min, self.mult_max + 1, 5 * i + 4)
            rows.append((at, KIND_SLOW_LINK, a, pack_slow_arg(b, mult), True))
            rows.append((at + dur, KIND_UNSLOW, a, pack_slow_arg(b, 1), True))
        return _pack_slots(len(seeds), rows, st.dev)

    def slot_templates(self) -> tuple:
        out = []
        for _ in range(self.n_links):
            out.append(SlotTemplate(
                kind=KIND_SLOW_LINK, t_min_ns=self.t_min_ns,
                t_max_ns=self.t_max_ns, targets=self.targets,
                arg_kind="slow", mult_min=self.mult_min,
                mult_max=self.mult_max,
            ))
            out.append(SlotTemplate(
                kind=KIND_UNSLOW,
                t_min_ns=self.t_min_ns + self.dur_min_ns,
                t_max_ns=self.t_max_ns + self.dur_max_ns,
                targets=self.targets, arg_kind="slow",
            ))
        return tuple(out)



@dataclasses.dataclass(frozen=True)
class Duplicate:
    """Message duplication for one random window: every send delivers a
    second copy with its own latency/loss draw. Requires the engine's
    ``dup_rows`` path, which search/shrink enable automatically when a
    plan contains this spec."""

    t_min_ns: int = 20_000_000
    t_max_ns: int = 400_000_000
    dur_min_ns: int = 50_000_000
    dur_max_ns: int = 400_000_000

    def __post_init__(self):
        _check_window(self.t_min_ns, self.t_max_ns, "dup-time")
        _check_window(self.dur_min_ns, self.dur_max_ns, "dup-duration")

    @property
    def slots(self) -> int:
        return 2

    def compile_batch(self, seeds, slot: int):
        st = _Stream(seeds, slot)
        at = st.uniform(self.t_min_ns, self.t_max_ns, 0)
        dur = st.uniform(self.dur_min_ns, self.dur_max_ns, 1)
        rows = [
            (at, KIND_DUP_ON, 0, 0, True),
            (at + dur, KIND_DUP_OFF, 0, 0, True),
        ]
        return _pack_slots(len(seeds), rows, st.dev)

    def slot_templates(self) -> tuple:
        return (
            SlotTemplate(
                kind=KIND_DUP_ON, t_min_ns=self.t_min_ns,
                t_max_ns=self.t_max_ns, arg_kind="none",
            ),
            SlotTemplate(
                kind=KIND_DUP_OFF,
                t_min_ns=self.t_min_ns + self.dur_min_ns,
                t_max_ns=self.t_max_ns + self.dur_max_ns, arg_kind="none",
            ),
        )



@dataclasses.dataclass(frozen=True)
class ClockSkew:
    """``n`` random nodes get a random clock skew (what their handlers
    observe as ``ctx.now``; the asyncio runtime skews ``SystemTime``).
    Skews persist to the end of the run — drifted clocks don't heal
    themselves."""

    targets: tuple
    n: int = 1
    t_min_ns: int = 0
    t_max_ns: int = 100_000_000
    skew_min_ns: int = -500_000_000
    skew_max_ns: int = 500_000_000

    def __post_init__(self):
        if not self.targets:
            raise ValueError("ClockSkew needs at least one target node")
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.skew_min_ns > self.skew_max_ns:
            raise ValueError("skew range is empty")
        # strict lower bound: skews land in the int32 skew column AND
        # the span (max+1 - min) must fit the uint32 draw reduction —
        # the ±(2^31 - 1) bound makes the maximal inclusive span
        # exactly DRAW_SPAN_MAX (the shared engine/rng.py contract),
        # so this one check enforces both
        lim = 2**31
        if not (-lim < self.skew_min_ns and self.skew_max_ns < lim):
            raise ValueError("skew must fit int32 nanoseconds (~±2.1 s)")
        _check_window(self.t_min_ns, self.t_max_ns, "skew-time")

    @property
    def slots(self) -> int:
        return self.n

    def compile_batch(self, seeds, slot: int):
        st = _Stream(seeds, slot)
        rows = []
        for i in range(self.n):
            who = st.pick(self.targets, 3 * i)
            at = st.uniform(self.t_min_ns, self.t_max_ns, 3 * i + 1)
            skew = st.uniform(self.skew_min_ns, self.skew_max_ns + 1, 3 * i + 2)
            rows.append((at, KIND_SKEW, who, skew, True))
        return _pack_slots(len(seeds), rows, st.dev)

    def slot_templates(self) -> tuple:
        return tuple(
            SlotTemplate(
                kind=KIND_SKEW, t_min_ns=self.t_min_ns,
                t_max_ns=self.t_max_ns, targets=self.targets,
                arg_kind="skew", skew_min_ns=self.skew_min_ns,
                skew_max_ns=self.skew_max_ns,
            )
            for _ in range(self.n)
        )



@dataclasses.dataclass(frozen=True)
class DiskFault:
    """Storage chaos for ``Workload.durable_sync`` workloads: the
    FoundationDB/sled disk-fault repertoire as composable windows.

    ``n_torn`` torn-write windows arm a random target node's torn-write
    mode for a random duration — a KILL landing inside the window
    persists only a drawn *prefix* of the node's last uncommitted
    durable write (the power-failure tear). ``n_sync_loss`` sync-lie
    windows make the node's disk silently drop sync commits — the
    firmware-lies-about-fsync fault; note a lying disk breaks the
    assumptions raft-class protocols are allowed to make, so clean-model
    certificates run torn-only windows and use sync-loss as the
    positive control for the recovery-safety detector. ``n_eio``
    windows make the node's disk fail *observably*: syncs stop
    committing AND the node's handlers see ``ctx.sync_err`` for the
    duration — the batched ``FsSim.set_fail_writes`` ``OSError(EIO)``.
    Unlike a lie, an EIO is a fault correct code is expected to
    SURVIVE (withhold the ack you could not persist), so EIO windows
    belong in clean-model certificates. On workloads without the sync
    discipline every window is a no-op (the identity-defaults rule of
    the other extended kinds)."""

    targets: tuple
    n_torn: int = 1
    n_sync_loss: int = 0
    n_eio: int = 0
    t_min_ns: int = 20_000_000
    t_max_ns: int = 400_000_000
    dur_min_ns: int = 50_000_000
    dur_max_ns: int = 400_000_000

    def __post_init__(self):
        if not self.targets:
            raise ValueError("DiskFault needs at least one target node")
        if self.n_torn < 0 or self.n_sync_loss < 0 or self.n_eio < 0:
            raise ValueError("window counts must be >= 0")
        if self.n_torn + self.n_sync_loss + self.n_eio < 1:
            raise ValueError(
                "DiskFault needs at least one torn, sync-loss or EIO "
                "window"
            )
        _check_window(self.t_min_ns, self.t_max_ns, "disk-fault-time")
        _check_window(self.dur_min_ns, self.dur_max_ns, "disk-fault-duration")

    @property
    def slots(self) -> int:
        return 2 * (self.n_torn + self.n_sync_loss + self.n_eio)

    def _windows(self):
        """(on-kind, off-kind, on-mode) per window, torn windows first,
        then sync-loss, then EIO — the spec-offset rule: growing a
        later count never re-randomizes the windows before it. The
        mode word is KIND_SYNC_LOSS's args[1]: 0 = silent lie, 1 =
        observable EIO (ctx.sync_err)."""
        return (
            [(KIND_TORN_ON, KIND_TORN_OFF, 0)] * self.n_torn
            + [(KIND_SYNC_LOSS, KIND_SYNC_OK, 0)] * self.n_sync_loss
            + [(KIND_SYNC_LOSS, KIND_SYNC_OK, 1)] * self.n_eio
        )

    def compile_batch(self, seeds, slot: int):
        st = _Stream(seeds, slot)
        rows = []
        for i, (k_on, k_off, mode) in enumerate(self._windows()):
            who = st.pick(self.targets, 3 * i)
            at = st.uniform(self.t_min_ns, self.t_max_ns, 3 * i + 1)
            dur = st.uniform(self.dur_min_ns, self.dur_max_ns, 3 * i + 2)
            rows.append((at, k_on, who, mode, True))
            rows.append((at + dur, k_off, who, 0, True))
        return _pack_slots(len(seeds), rows, st.dev)

    def slot_templates(self) -> tuple:
        out = []
        for k_on, k_off, _mode in self._windows():
            out.append(SlotTemplate(
                kind=k_on, t_min_ns=self.t_min_ns, t_max_ns=self.t_max_ns,
                targets=self.targets,
            ))
            out.append(SlotTemplate(
                kind=k_off,
                t_min_ns=self.t_min_ns + self.dur_min_ns,
                t_max_ns=self.t_max_ns + self.dur_max_ns,
                targets=self.targets,
            ))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """A client-side timeout and backoff retry policy for a
    :class:`ClientArmy`, which the engine itself runs: each delivered op
    arms a response-deadline timer in the pool, and when it expires the
    op is offered again with the next attempt id (packed into the op
    token) unless a response was recorded meanwhile. ``max_attempts``
    counts deliveries; the backoff before attempt ``a >= 1`` is
    ``backoff_base_ns * backoff_mult**(a-1)``, jittered by a
    ``PURPOSE_RETRY`` draw scaled to ``[0, jitter]`` of the backoff, so
    every re-send time is a function of the seed.

    Attach with ``ClientArmy(..., retry=RetryPolicy(timeout_ns=...))``
    (the models' ``client_army`` helpers forward ``retry=``), then build
    the engine with ``retry=plan.retry_spec()``.
    """

    timeout_ns: int
    max_attempts: int = 3
    backoff_base_ns: int = 0
    backoff_mult: float = 2.0
    jitter: float = 0.0

    def __post_init__(self):
        # the engine spec holds the validation; the army's fields are
        # stubbed with valid values so a bad policy fails here
        RetrySpec(
            kind=FIRST_USER_KIND, node=0, op_base=0, n_ops=1,
            timeout_ns=self.timeout_ns, max_attempts=self.max_attempts,
            backoff_base_ns=self.backoff_base_ns,
            backoff_mult=self.backoff_mult, jitter=self.jitter,
        )


@dataclasses.dataclass(frozen=True)
class ClientArmy:
    """Open-loop client load: ``n_ops`` user-kind pool rows delivered to
    ``node`` at threefry-drawn arrival times.

    The arrivals are compiled from ``(seed, PURPOSE_CLIENT + slot)``
    coordinates into pre-seeded pool rows, so the offered load is a pure
    function of the seed: the same arrival schedule hits the protocol
    whatever the faults do to it, which makes tail latency a measurable
    property instead of a feedback artifact. Op ``i``'s row carries
    ``args = (op_base + i, arg word)``: the op id indexes the latency
    columns (``LatencySpec.ops`` must cover ``op_base + n_ops``), and
    the arg word is a uniform draw in [0, ``arg_hi``) (0 when
    ``arg_hi`` is 0). ``kind`` is the workload's client handler; the
    models' ``client_army`` helpers bind it. It composes into a
    :class:`FaultPlan` like any fault spec.
    """

    node: int  # target node (the workload's client surface)
    kind: int  # user kind of the client handler (engine user_kind)
    n_ops: int = 256
    t_min_ns: int = 20_000_000
    t_max_ns: int = 400_000_000
    arg_hi: int = 0  # args[1] drawn uniform in [0, arg_hi); 0 = constant 0
    op_base: int = 0  # first op id (several armies share the columns)
    # the timeout and backoff retry policy; None is the fire-and-forget
    # army. The compiled rows are the same either way (attempt-0 tokens
    # are plain op ids): the policy changes only the engine build
    retry: "RetryPolicy | None" = None

    def __post_init__(self):
        if self.node < 0:
            raise ValueError(f"ClientArmy node must be >= 0, got {self.node}")
        if not FIRST_USER_KIND <= self.kind < FIRST_EXT_KIND:
            raise ValueError(
                f"ClientArmy.kind={self.kind} is not a user kind "
                f"(engine.user_kind range [{FIRST_USER_KIND}, "
                f"{FIRST_EXT_KIND})) — pass user_kind(handler_index)"
            )
        if self.n_ops < 1:
            raise ValueError(f"n_ops must be >= 1, got {self.n_ops}")
        if self.arg_hi < 0:
            raise ValueError(f"arg_hi must be >= 0, got {self.arg_hi}")
        if self.op_base < 0:
            raise ValueError(f"op_base must be >= 0, got {self.op_base}")
        if self.retry is not None:
            if not isinstance(self.retry, RetryPolicy):
                raise TypeError(
                    f"ClientArmy.retry must be a RetryPolicy or None, "
                    f"got {type(self.retry).__name__}"
                )
            # the engine spec's validations (the op range against the
            # token's op field) fail at plan time
            self.retry_spec()
        _check_window(self.t_min_ns, self.t_max_ns, "arrival")

    def retry_spec(self) -> "RetrySpec":
        """The engine-side spec of this army's retry policy
        (``engine.make_run_while(retry=...)``). Raises when no policy is
        attached; :meth:`FaultPlan.retry_spec` maps such a plan to None."""
        if self.retry is None:
            raise ValueError("this ClientArmy has no RetryPolicy attached")
        r = self.retry
        return RetrySpec(
            kind=self.kind, node=self.node, op_base=self.op_base,
            n_ops=self.n_ops, timeout_ns=r.timeout_ns,
            max_attempts=r.max_attempts,
            backoff_base_ns=r.backoff_base_ns,
            backoff_mult=r.backoff_mult, jitter=r.jitter,
        )

    @property
    def targets(self) -> tuple:
        """The node this army addresses (validated like a spec's targets)."""
        return (self.node,)

    @property
    def slots(self) -> int:
        return self.n_ops

    def compile_batch(self, seeds, slot: int):
        # the client stream is namespaced under PURPOSE_CLIENT: arrival
        # draws never alias a chaos spec's, even inside one plan
        st = _Stream(seeds, slot, purpose=PURPOSE_CLIENT)
        rows = []
        for i in range(self.n_ops):
            at = st.uniform(self.t_min_ns, self.t_max_ns, 2 * i)
            word = st.uniform(0, self.arg_hi, 2 * i + 1) if self.arg_hi else 0
            rows.append((at, self.kind, self.op_base + i, word, True, self.node))
        return _pack_slots(len(seeds), rows, st.dev)

    def slot_templates(self) -> tuple:
        # retime within the arrival window, drop or add ops; the args
        # stay fixed: the op id is the latency slot
        return tuple(
            SlotTemplate(
                kind=self.kind, t_min_ns=self.t_min_ns,
                t_max_ns=self.t_max_ns, arg_kind="none",
            )
            for _ in range(self.n_ops)
        )


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def _check_user_kind(kind: int, wl, what: str) -> None:
    """User-kind plan rows must name a REAL handler of this workload:
    the engine's dispatch clamps out-of-range user kinds to the last
    handler (a documented no-crash rule for emit-time corruption), so
    an army row aimed at a workload without the client surface would
    silently dispatch the wrong handler instead of erroring."""
    if not FIRST_USER_KIND <= kind < FIRST_EXT_KIND:
        return
    n_handlers = len(wl.handlers)
    if kind - FIRST_USER_KIND >= n_handlers:
        raise ValueError(
            f"{what} injects user kind {kind} (handler index "
            f"{kind - FIRST_USER_KIND}), but workload {wl.name!r} has "
            f"only {n_handlers} handlers — a client army needs the "
            f"workload built with its client surface enabled "
            f"(e.g. make_kvchaos(army=True))"
        )


def _device_seeds(seeds) -> torch.Tensor:
    """Seeds for the device compile, as uint64 bit patterns in int64: a
    tensor stays on its device, numpy seeds land on the CPU."""
    return _seeds_tensor(seeds, seeds.device if isinstance(seeds, torch.Tensor) else "cpu")


def _validate_targets(specs, wl) -> None:
    n = wl.n_nodes
    for spec in specs:
        for node in getattr(spec, "targets", ()):
            if not 0 <= int(node) < n:
                raise ValueError(
                    f"{type(spec).__name__} targets node {node}, but "
                    f"workload {wl.name!r} has n_nodes={n}"
                )
        kind = getattr(spec, "kind", None)
        if isinstance(kind, int):
            _check_user_kind(kind, wl, type(spec).__name__)


class _PlanBase:
    """Shared surface of FaultPlan and LiteralPlan (what search/shrink
    consume): ``slots``, ``uses_dup()``, ``hash()``, ``compile_batch``,
    ``compile``."""

    def compile(self, seed: int) -> list[FaultEvent]:
        """The concrete fault trajectory of one seed, in slot order."""
        rows = self.compile_batch(np.asarray([seed], np.uint64))
        # both plan forms always materialize the node column; only
        # hand-built PlanRows (the make_init boundary) may carry None
        node = rows.node
        out = []
        for j in range(rows.time.shape[1]):
            if bool(rows.valid[0, j]):
                out.append(
                    FaultEvent(
                        t=int(rows.time[0, j]),
                        kind=int(rows.kind[0, j]),
                        a0=int(rows.args[0, j, 0]),
                        a1=int(rows.args[0, j, 1]),
                        node=int(node[0, j]),
                    )
                )
        return out

    def describe(self, seed: int) -> str:
        lines = [f"plan {self.hash()} @ seed {seed}:"]
        lines += [f"  {ev}" for ev in sorted(self.compile(seed), key=lambda e: e.t)]
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class FaultPlan(_PlanBase):
    """A declarative nemesis: a tuple of fault specs, compiled per seed.

    ::

        plan = FaultPlan((
            CrashStorm(targets=(1, 2, 3, 4), n=2),
            GrayFailure(targets=(0, 1, 2, 3, 4)),
        ))
        report = search_seeds(wl, cfg, inv, plan=plan, ...)
        print(plan.describe(int(report.failing_seeds[0])))
    """

    specs: tuple
    name: str = "nemesis"

    def __post_init__(self):
        if not self.specs:
            raise ValueError("FaultPlan needs at least one fault spec")

    @property
    def slots(self) -> int:
        return sum(s.slots for s in self.specs)

    def uses_dup(self) -> bool:
        return any(isinstance(s, Duplicate) for s in self.specs)

    def retry_spec(self) -> "RetrySpec | None":
        """The engine retry build parameter this plan implies: the
        policied ClientArmy's :class:`RetrySpec`, or None when no army
        carries a policy. The engine tracks one op range, so two
        policied armies in one plan are refused."""
        specs = [
            s for s in self.specs
            if isinstance(s, ClientArmy) and s.retry is not None
        ]
        if not specs:
            return None
        if len(specs) > 1:
            raise ValueError(
                f"plan {self.name!r} attaches RetryPolicy to "
                f"{len(specs)} client armies; the engine tracks one "
                f"retried op range per build"
            )
        return specs[0].retry_spec()

    def hash(self) -> str:
        """Stable hex id of the plan (EngineConfig.hash analog): the
        spec tuple fully determines every compiled trajectory."""
        return hashlib.sha256(repr(self.specs).encode()).hexdigest()[:16]

    def min_pool_size(self, wl, headroom: int = 16, tile_align: bool = True) -> int:
        """Smallest ``EngineConfig.pool_size`` this plan's pre-seeded
        rows fit into: one on_init row per node + every plan slot +
        ``headroom`` for in-flight protocol traffic per pending op.

        ``tile_align=True`` (default) rounds up to the next readiness-
        index tile multiple (``engine.pool_tile``), so an army-scale
        pool sized through here is never locked OUT of the O(ready)
        indexed pop by a missing tile divisor — client armies are
        exactly the pools where the flat O(E) scan hurts (ROADMAP
        items 2/4). The index still engages only past the measured
        auto threshold (pools > 1024 slots; below it the flat lowering
        is the faster program — pass ``pool_index=True`` explicitly to
        override). Headroom is a floor, not a proof: run the sweep
        once and check ``overflow == 0`` (the bench rule) before
        trusting a sizing.
        """
        base = wl.n_nodes + self.slots + max(int(headroom), 0)
        if not tile_align:
            return base
        tile = POOL_TILE_CANDIDATES[0]
        return ((base + tile - 1) // tile) * tile

    def validate_windows(self, time_limit_ns: int, warn: bool = True):
        """Specs whose fire window opens at-or-after ``time_limit_ns``.

        The default CrashStorm/PauseStorm windows (20-400 ms) were tuned
        for long chaos runs; a short workload (raft halts its scenario
        in ~200-300 ms, or ``cfg.time_limit_ns`` caps the clock) can
        halt before a late window ever opens, silently turning the storm
        into a no-op — the sweep then certifies the UNFAULTED protocol.
        ``search_seeds`` calls this automatically when the config sets a
        time limit; ``warn=True`` (default) emits one UserWarning naming
        the dead specs. Returns the offending spec list (empty = fine).
        Use :meth:`clamped` to shrink the windows instead.
        """
        late = [
            s
            for s in self.specs
            if getattr(s, "t_min_ns", None) is not None
            and s.t_min_ns >= time_limit_ns
        ]
        if late and warn:
            names = ", ".join(
                f"{type(s).__name__}(t_min_ns={s.t_min_ns})" for s in late
            )
            warnings.warn(
                f"fault plan {self.name!r}: {names} cannot fire before "
                f"the {time_limit_ns} ns time limit — the run will see "
                f"no such fault (shrink the window, or use "
                f"plan.clamped(time_limit_ns))",
                UserWarning,
                stacklevel=3,
            )
        return late

    def clamped(self, time_limit_ns: int) -> "FaultPlan":
        """A copy with every spec's fire window intersected with
        ``[0, time_limit_ns)`` — the warn-or-clamp companion of
        :meth:`validate_windows`. Durations are untouched (a fault may
        legitimately heal after the limit); specs without a time window
        pass through. NOTE: clamping changes the spec tuple, so the
        plan hash (and every compiled trajectory) changes with it."""
        if time_limit_ns <= 0:
            raise ValueError(f"time_limit_ns must be > 0, got {time_limit_ns}")
        specs = []
        for s in self.specs:
            t_min = getattr(s, "t_min_ns", None)
            t_max = getattr(s, "t_max_ns", None)
            if t_min is None or t_max is None:
                specs.append(s)
                continue
            new_min = min(t_min, max(time_limit_ns - 1, 0))
            new_max = max(min(t_max, time_limit_ns), new_min)
            specs.append(
                dataclasses.replace(s, t_min_ns=new_min, t_max_ns=new_max)
            )
        return dataclasses.replace(self, specs=tuple(specs))

    def compile_batch(self, seeds, wl=None, device: bool = False) -> PlanRows:
        """Compile the whole seed batch to engine pool rows (S, slots).

        Spec ``i`` draws from plan slots ``[offset_i, offset_i +
        spec.slots)``, so adding a spec never re-randomizes the ones
        before it.

        ``device=True`` compiles with torch ops where the seeds live (a
        tensor's device; numpy seeds compile on the CPU) and returns
        tensors there: a device campaign never ships (S, P) rows from
        the host. Bit-identical to the numpy path (the parity test pins
        it).
        """
        if wl is not None:
            _validate_targets(self.specs, wl)
        seeds = _device_seeds(seeds) if device else np.asarray(seeds, np.uint64)
        parts = []
        off = 0
        for spec in self.specs:
            parts.append(spec.compile_batch(seeds, off))
            off += spec.slots
        cat = (lambda xs: torch.cat(xs, dim=1)) if device else (
            lambda xs: np.concatenate(xs, axis=1))
        return PlanRows(
            time=cat([p[0] for p in parts]),
            kind=cat([p[1] for p in parts]),
            args=cat([p[2] for p in parts]),
            valid=cat([p[3] for p in parts]),
            node=cat([p[4] for p in parts]),
        )

    def slot_templates(self) -> tuple:
        """One :class:`SlotTemplate` per plan slot, spec order — the
        mutation surface madsim_tpu.explore perturbs."""
        out = []
        for spec in self.specs:
            out += list(spec.slot_templates())
        return tuple(out)

    def literalize(self, seed: int, wl=None) -> "LiteralPlan":
        """This seed's compiled trajectory as a :class:`LiteralPlan`
        with the SAME pool layout: every slot is kept (invalid slots
        become disabled-but-reserved entries), so the literal replays
        the FaultPlan run bit-identically — the corpus-entry form of
        madsim_tpu.explore."""
        rows = self.compile_batch(np.asarray([seed], np.uint64), wl=wl)
        node = rows.node
        events = tuple(
            FaultEvent(
                t=int(rows.time[0, j]),
                kind=int(rows.kind[0, j]),
                a0=int(rows.args[0, j, 0]),
                a1=int(rows.args[0, j, 1]),
                node=int(node[0, j]),
            )
            for j in range(rows.time.shape[1])
        )
        enabled = tuple(bool(x) for x in rows.valid[0])
        return LiteralPlan(
            events=events, enabled=enabled, name=f"{self.name}@{int(seed)}"
        )


@dataclasses.dataclass(frozen=True)
class LiteralPlan(_PlanBase):
    """An explicit, seed-independent event list — the replayable form the
    shrinker emits.

    ``enabled`` masks individual slots while keeping the pool layout (and
    therefore the trajectory, including argmin tie-breaks on equal event
    times) identical to the run that was shrunk: a disabled slot stays
    reserved-but-invalid exactly as it was during ddmin. ``compile``
    returns only the enabled events."""

    events: tuple
    enabled: tuple = ()
    name: str = "literal"

    def __post_init__(self):
        if self.enabled and len(self.enabled) != len(self.events):
            raise ValueError("enabled mask length must match events")

    @property
    def slots(self) -> int:
        return len(self.events)

    def _mask(self) -> np.ndarray:
        if self.enabled:
            return np.asarray(self.enabled, bool)
        return np.ones((len(self.events),), bool)

    def uses_dup(self) -> bool:
        return any(
            e.kind in (KIND_DUP_ON, KIND_DUP_OFF)
            for e, on in zip(self.events, self._mask())
            if on
        )

    def hash(self) -> str:
        payload = repr((self.events, tuple(self._mask().tolist())))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


    def compile_batch(self, seeds, wl=None, device: bool = False) -> PlanRows:
        """This plan's rows for every seed (the same events each time).
        ``device=True`` returns them as tensors on the seeds' device
        (numpy seeds: the CPU), as :meth:`FaultPlan.compile_batch`."""
        if wl is not None:
            for e, on in zip(self.events, self._mask()):
                if on:
                    _check_user_kind(e.kind, wl, "LiteralPlan event")
        if device:
            seeds = _device_seeds(seeds)
            s, p, dev = seeds.shape[0], len(self.events), seeds.device

            def col(vals, dtype, shape):
                t = torch.tensor(vals, dtype=dtype, device=dev).reshape(shape)
                return t.expand((s, *shape))

            return PlanRows(
                time=col([e.t for e in self.events], torch.int64, (p,)),
                kind=col([e.kind for e in self.events], torch.int32, (p,)),
                args=col([(e.a0, e.a1) for e in self.events], torch.int32, (p, 2)),
                valid=col(self._mask().tolist(), torch.bool, (p,)),
                node=col([e.node for e in self.events], torch.int32, (p,)),
            )
        seeds = np.asarray(seeds, np.uint64)
        s, p = len(seeds), len(self.events)
        time = np.asarray([e.t for e in self.events], np.int64)
        kind = np.asarray([e.kind for e in self.events], np.int32)
        args = np.asarray(
            [(e.a0, e.a1) for e in self.events], np.int32
        ).reshape(p, 2)
        node = np.asarray([e.node for e in self.events], np.int32)
        mask = self._mask()
        # numpy rows stay writable copies: the shrinker masks them in place
        return PlanRows(
            time=np.broadcast_to(time, (s, p)).copy(),
            kind=np.broadcast_to(kind, (s, p)).copy(),
            args=np.broadcast_to(args, (s, p, 2)).copy(),
            valid=np.broadcast_to(mask, (s, p)).copy(),
            node=np.broadcast_to(node, (s, p)).copy(),
        )

    def to_dict(self) -> dict:
        """JSON-ready form (the exploration corpus/artifact format).
        The node word is appended only when some event targets one, so
        pre-army artifacts stay byte-identical."""
        if any(e.node for e in self.events):
            events = [[e.t, e.kind, e.a0, e.a1, e.node] for e in self.events]
        else:
            events = [[e.t, e.kind, e.a0, e.a1] for e in self.events]
        return {
            "name": self.name,
            "events": events,
            "enabled": [bool(x) for x in self._mask()],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LiteralPlan":
        return cls(
            events=tuple(
                FaultEvent(
                    t=int(row[0]), kind=int(row[1]), a0=int(row[2]),
                    a1=int(row[3]),
                    node=int(row[4]) if len(row) > 4 else 0,
                )
                for row in d["events"]
            ),
            enabled=tuple(bool(x) for x in d.get("enabled", ())),
            name=d.get("name", "literal"),
        )


def stack_plan_rows(plans) -> PlanRows:
    """Stack per-row :class:`LiteralPlan` objects (equal slot counts)
    into one batch: row ``i`` of the returned :class:`PlanRows` carries
    ``plans[i]``. This is the heterogeneous form a mutated exploration
    generation needs — ``compile_batch`` broadcasts ONE plan over every
    seed, while here every seed runs its own mutant."""
    if not plans:
        raise ValueError("stack_plan_rows needs at least one plan")
    p = plans[0].slots
    for pl in plans:
        if pl.slots != p:
            raise ValueError(
                f"all plans must share one slot count; got {pl.slots} != {p}"
            )
    return PlanRows(
        time=np.array(
            [[e.t for e in pl.events] for pl in plans], np.int64
        ).reshape(len(plans), p),
        kind=np.array(
            [[e.kind for e in pl.events] for pl in plans], np.int32
        ).reshape(len(plans), p),
        args=np.array(
            [[(e.a0, e.a1) for e in pl.events] for pl in plans], np.int32
        ).reshape(len(plans), p, 2),
        valid=np.array([pl._mask() for pl in plans], bool).reshape(
            len(plans), p
        ),
        node=np.array(
            [[e.node for e in pl.events] for pl in plans], np.int32
        ).reshape(len(plans), p),
    )
