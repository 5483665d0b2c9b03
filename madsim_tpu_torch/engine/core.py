"""Batched discrete-event simulation core, on torch tensors.

Port of ``madsim_tpu/engine/core.py`` for the main path: one
:class:`SimState` row per seed, and one step that advances every seed
by one event — pop the earliest valid pool slot, gate it on liveness,
epoch, clog and pause, dispatch the engine kinds inline and the user
handlers by kind, apply kill/restart/pause/clog/halt, place the emits
into free slots, fold the trace hash and advance the clock.

A compiled fault plan (``chaos/plan.py``) rides in the pool:
``make_init(plan_slots=P)`` seeds its rows, and the step dispatches the
extended chaos kinds (244-254) beside the engine kinds; ``dup_rows``
adds the message-duplication shadow rows.

A workload with a :class:`HistorySpec` also records operation
histories: its handlers call :meth:`EmitBuilder.record`, and the step
appends a user dispatch's records to the ``hist_*`` columns of the
state, which the ``check`` package judges.

A workload with ``durable_sync`` keeps the two-phase sync discipline
over its durable columns: a durable write survives a kill only once a
handler's :meth:`EmitBuilder.sync` has committed it to the node's disk
image (``SimState.disk``), and the disk-fault kinds 251-254 make syncs
lie or fail and kills tear the last uncommitted write. Built with
``metrics=True``, the step also folds the fleet counters ``MET_*`` into
``SimState.met``, which never feed back into the trajectory. So do the
other observability taps: ``cov_words`` (and ``cov_hitcount``) fold each
dispatch's behavior features into a per-seed coverage bitmap, with
``Workload.cov_features`` adding the workload's own, and
``timeline_cap`` records the dispatched events in a per-seed ring that
``obs.decode_timeline`` reads. ``latency=LatencySpec(...)`` runs the
tail-latency tap: handlers mark client ops' invokes and responses
(:meth:`EmitBuilder.lat_start`, :meth:`EmitBuilder.lat_end`), and the
step stamps per-op clocks and folds each completed op into a per-seed
log-linear sketch (``lat_hist``), also derived state only.
``causal=True`` folds causal provenance beside them: each node's Lamport
clock (``lam``), each pool row's emitting dispatch and the clock it
folded (``ev_parent``, ``ev_lam``) and, with the ring, each captured
row's dispatch seq, parent seq and folded clock (``tl_seq``,
``tl_parent``, ``tl_lam``), the event-derivation DAG that
``obs.causal`` reads. ``retry=RetrySpec(...)`` (a client army's
``chaos.RetryPolicy``) runs client retries as simulator state: each
delivered army op arms a re-send timer row, the op's ``lat_end`` marker
disarms it, and the books ``rt_done``, ``rt_attempt`` and
``rt_deadline`` are core state, since ``rt_done`` decides whether a
re-sent row delivers.

The JAX engine has several lowerings of that step (dense/scatter
layout, rank/scatter placement, time32, the pool index); their values
are identical by construction, so this port has one: int64 absolute
event times, row-indexed reads and writes. It is held against the JAX
engine built with ``layout="scatter", time32=False``.

Integer representation (torch has no unsigned arithmetic past uint8):

* ``step`` and ``ev_meta`` hold uint32 values in int64 tensors, masked
  to 32 bits;
* ``seed`` and ``trace`` hold uint64 bit patterns in int64 tensors —
  multiply, add, xor and left shift agree with the unsigned ones;
* ``engine/convert.py`` is the only place that converts to the JAX
  package's numpy dtypes.

Entry points run on the card unless the caller asks for the CPU:
``make_init(..., device=None)`` means ``"cuda"`` and raises when no card
is present. On a CUDA state, :func:`make_step`, :func:`make_run` and
:func:`make_run_while` launch the fused run kernel (``engine/fused.py``);
the plain eager step stays reachable on any device through
:func:`make_step_plain`, :func:`make_run_plain` and
:func:`make_run_while_plain`.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable

import numpy as np
import torch

from .rng import (
    DRAW_SPAN_MAX,
    M32,
    PURPOSE_DUP,
    PURPOSE_LATENCY,
    PURPOSE_LOSS,
    PURPOSE_POLL_COST,
    PURPOSE_RETRY,
    PURPOSE_TORN,
    PURPOSE_USER,
    Draw,
    chance_threshold,
    lane,
)

__all__ = [
    "EngineConfig",
    "Workload",
    "SimState",
    "Emits",
    "EmitBuilder",
    "HandlerCtx",
    "HistorySpec",
    "KIND_KILL",
    "KIND_RESTART",
    "KIND_CLOG",
    "KIND_UNCLOG",
    "KIND_CLOG_NODE",
    "KIND_UNCLOG_NODE",
    "KIND_HALT",
    "KIND_NOP",
    "KIND_PAUSE",
    "KIND_RESUME",
    "FIRST_USER_KIND",
    "FIRST_EXT_KIND",
    "KIND_SLOW_LINK",
    "KIND_UNSLOW",
    "KIND_DUP_ON",
    "KIND_DUP_OFF",
    "KIND_SKEW",
    "KIND_CLOG_1W",
    "KIND_UNCLOG_1W",
    "KIND_SYNC_LOSS",
    "KIND_SYNC_OK",
    "KIND_TORN_ON",
    "KIND_TORN_OFF",
    "SLOW_MULT_MAX",
    "POOL_TILE_CANDIDATES",
    "MET_SENT",
    "MET_DELIVERED",
    "MET_LOST",
    "MET_DEAD_DROP",
    "MET_DUP",
    "MET_CRASH",
    "MET_RESTART",
    "MET_PAUSE",
    "MET_CLOG_BLOCK",
    "MET_TIMER",
    "MET_RECORD",
    "MET_RNG",
    "MET_HALT_CODE",
    "MET_SYNC",
    "MET_SYNC_LOST",
    "MET_TORN",
    "MET_RETRY",
    "MET_RETRY_GIVEUP",
    "N_METRICS",
    "METRIC_NAMES",
    "HALT_RUNNING",
    "HALT_DONE",
    "HALT_TIME_LIMIT",
    "HALT_IDLE",
    "STORAGE_FIELDS",
    "COVERAGE_FIELDS",
    "TIMELINE_FIELDS",
    "OBS_FIELDS",
    "LATENCY_FIELDS",
    "CAUSAL_STATE_FIELDS",
    "RETRY_STATE_FIELDS",
    "PARENT_NONE",
    "PARENT_PLAN",
    "PARENT_ARMY",
    "ABSINT_STEP_MAX",
    "ABSINT_HORIZON_NS",
    "ABSINT_COUNTER_MAX",
    "DERIVED_STATE_FIELDS",
    "derived_fields",
    "core_fields",
    "ColumnContract",
    "StateContract",
    "column_contracts",
    "N_LAT_BUCKETS",
    "LAT_EDGES_NS",
    "lat_bucket",
    "lat_bucket_lo",
    "lat_bucket_hi",
    "LatencySpec",
    "RETRY_ATTEMPT_SHIFT",
    "RETRY_ATTEMPT_MAX",
    "RETRY_OP_MASK",
    "retry_token",
    "retry_token_op",
    "retry_token_attempt",
    "RetrySpec",
    "PlanRows",
    "pack_slow_arg",
    "unpack_slow_arg",
    "user_kind",
    "get_col",
    "set_col",
    "set_cols",
    "resolve_device",
    "host_to_device",
    "obs_widths",
    "check_obs_state",
    "lat_widths",
    "check_lat_state",
    "causal_on",
    "check_causal_state",
    "retry_width",
    "check_retry_state",
    "make_init",
    "make_step",
    "make_step_plain",
    "make_run",
    "make_run_plain",
    "make_run_while",
    "make_run_while_plain",
]

_INF_NS = 2**62

# ---------------------------------------------------------------------------
# Event kinds. Engine kinds first, so user handler k has kind
# FIRST_USER_KIND + k whatever the workload; handler 0 is on_init.
# ---------------------------------------------------------------------------
KIND_KILL = 0  # args[0]=node
KIND_RESTART = 1  # args[0]=node
KIND_CLOG = 2  # args[0]=a args[1]=b
KIND_UNCLOG = 3  # args[0]=a args[1]=b
KIND_CLOG_NODE = 4  # args[0]=node
KIND_UNCLOG_NODE = 5  # args[0]=node
KIND_HALT = 6  # scenario complete: freeze this seed's instance
KIND_NOP = 7
KIND_PAUSE = 8  # args[0]=node
KIND_RESUME = 9  # args[0]=node
FIRST_USER_KIND = 10
# Extended chaos kinds (``chaos/plan.py``), at the top of the kind byte:
# engine kinds again (no epoch or pause gate). The disk-fault kinds
# 251-254 act only on a workload with the sync discipline
# (``Workload.durable_sync``); on any other they fold into the trace and
# change no state.
FIRST_EXT_KIND = 244
KIND_SLOW_LINK = 244  # args[0]=a args[1]=pack_slow_arg(b, mult): a<->b
#                       latency times mult (b=-1: every link of a)
KIND_UNSLOW = 245  # args[0]=a args[1]=pack_slow_arg(b, 1): back to x1
KIND_DUP_ON = 246  # message duplication (needs dup_rows)
KIND_DUP_OFF = 247
KIND_SKEW = 248  # args[0]=node args[1]=skew ns: its handlers see now+skew
KIND_CLOG_1W = 249  # args[0]=src args[1]=dst: one direction only
KIND_UNCLOG_1W = 250
KIND_SYNC_LOSS = 251  # args[0]=node (-1: every node), args[1]=0 lie, 1 EIO:
#                       the node's syncs stop committing; in EIO mode its
#                       handlers also see ctx.sync_err
KIND_SYNC_OK = 252  # ends both windows: syncs commit again
KIND_TORN_ON = 253  # a kill persists a drawn prefix (PURPOSE_TORN) of the
#                     node's last uncommitted durable write
KIND_TORN_OFF = 254

# Fleet-metric slots: SimState.met is an (N_METRICS,) int32 row per seed
# with metrics=True, else (0,). Every slot but MET_HALT_CODE is a
# counter folded at dispatch from values the step already computes; no
# slot feeds back into the trajectory. The slot ids are the JAX
# package's.
MET_SENT = 0  # valid send emits of a dispatch, lost or not
MET_DELIVERED = 1  # message deliveries dispatched (src >= 0)
MET_LOST = 2  # sends dropped by the loss draw
MET_DEAD_DROP = 3  # sends dropped because the destination was dead
MET_DUP = 4  # duplicated deliveries placed (the dup_rows shadow rows)
MET_CRASH = 5  # KIND_KILL dispatches
MET_RESTART = 6  # KIND_RESTART dispatches
MET_PAUSE = 7  # KIND_PAUSE dispatches
MET_CLOG_BLOCK = 8  # delivery attempts held by a clogged link
MET_TIMER = 9  # user timer fires (user dispatches with no sender)
MET_RECORD = 10  # history records appended
MET_RNG = 11  # threefry blocks of the step's batch while the seed is active
MET_HALT_CODE = 12  # not a counter: the HALT_* code of how the seed stopped
MET_SYNC = 13  # sync commits honoured (durable_sync)
MET_SYNC_LOST = 14  # syncs that did not commit inside a KIND_SYNC_LOSS window
MET_TORN = 15  # kills of a node whose torn-write mode was armed
MET_RETRY = 16  # army re-deliveries dispatched (attempt > 0 that ran)
MET_RETRY_GIVEUP = 17  # ops abandoned: the max_attempts-th timer fired
N_METRICS = 18

METRIC_NAMES = (
    "sent", "delivered", "lost", "dead_drop", "dup", "crash", "restart",
    "pause", "clog_block", "timer", "record", "rng_blocks", "halt_code",
    "sync", "sync_lost", "torn", "retry", "retry_giveup",
)

# MET_HALT_CODE values
HALT_RUNNING = 0  # still live, or stopped only by the step cap
HALT_DONE = 1  # the workload emitted KIND_HALT
HALT_TIME_LIMIT = 2  # cfg.time_limit_ns tripped
HALT_IDLE = 3  # the event pool ran empty while unhalted: nothing will happen

# the sync discipline's columns of SimState (zero-size without it)
STORAGE_FIELDS = ("disk", "wmask", "sync_loss", "sync_eio", "torn")
# the coverage taps' columns (zero-size with cov_words=0) and the
# timeline ring's (zero-size with timeline_cap=0; tl_count and tl_drop
# stay 0), with the ring's emit-time sidecar ev_emit: derived state
COVERAGE_FIELDS = ("cov", "cov_last", "cov_hits")
TIMELINE_FIELDS = ("tl_count", "tl_drop", "tl_t", "tl_meta", "tl_args", "tl_pay", "tl_emit")
OBS_FIELDS = (*COVERAGE_FIELDS, *TIMELINE_FIELDS, "ev_emit")
# the tail-latency tap's columns (zero-size, and the counters 0, without
# a LatencySpec): derived state
LATENCY_FIELDS = ("lat_inv", "lat_resp", "lat_hist", "lat_count", "lat_drop")
# the causal-provenance columns (zero-size with causal=False): derived
# state, read only into more causal columns and the ring
CAUSAL_STATE_FIELDS = ("lam", "ev_parent", "ev_lam", "tl_seq", "tl_parent", "tl_lam")
# the client-retry columns (zero-size without a RetrySpec): core state,
# since rt_done gates the re-delivery of an op
RETRY_STATE_FIELDS = ("rt_done", "rt_attempt", "rt_deadline")
# ev_parent's sentinel classes: a pool row whose value is below zero has
# no emitting dispatch; obs.causal treats such rows as roots of the DAG
PARENT_NONE = -1  # on_init rows and never-written slots
PARENT_PLAN = -2  # compiled fault-plan rows (engine and extended chaos kinds)
PARENT_ARMY = -3  # client-army plan rows (open-loop user-kind arrivals)
# the certified run length: a dispatch's seq is min(step, this - 1), so
# it fits an int32
ABSINT_STEP_MAX = 1 << 31

# the largest slow-link multiplier pack_slow_arg's word carries (bits
# 8..30 of an int32)
SLOW_MULT_MAX = (1 << 23) - 1
# the JAX package's readiness-index tile widths; FaultPlan.min_pool_size
# rounds a pool up to the first
POOL_TILE_CANDIDATES = (64, 32, 16, 8)

# ---------------------------------------------------------------------------
# The tail-latency sketch ladder. Each completed client op's latency
# folds into a per-seed histogram over a fixed ladder, so sketches merge
# exactly (the sketch of a union is the sum of the sketches) in integer
# arithmetic. Bucket 0 holds [0, 64 us); buckets 1..62 are
# quarter-octaves (edge ratio 2^(1/4)) from 64 us up to about 3.0 s;
# bucket 63 saturates above that. The 63 edges are rounded to int64 once
# on the host, and the kernel's copy (csrc/engine_step.cuh kLatEdges)
# is these literals.
# ---------------------------------------------------------------------------
N_LAT_BUCKETS = 64
_LAT_EDGE0_NS = 1 << 16  # 65.536 us
LAT_EDGES_NS = np.asarray(
    [int(round(_LAT_EDGE0_NS * 2.0 ** (b / 4.0))) for b in range(N_LAT_BUCKETS - 1)],
    np.int64,
)


def lat_bucket(v_ns) -> np.ndarray:
    """Host-side ladder lookup: the bucket of a latency, the count of
    edges at or below it (vectorized)."""
    return np.searchsorted(LAT_EDGES_NS, np.asarray(v_ns, np.int64), side="right")


def lat_bucket_lo(b) -> np.ndarray:
    """Inclusive lower edge of bucket ``b`` (0 for bucket 0)."""
    b = np.asarray(b, np.int64)
    return np.where(b <= 0, 0, LAT_EDGES_NS[np.clip(b - 1, 0, N_LAT_BUCKETS - 2)])


def lat_bucket_hi(b) -> np.ndarray:
    """Exclusive upper edge of bucket ``b``; the top bucket reports the
    last edge (its values lie above it)."""
    b = np.asarray(b, np.int64)
    return LAT_EDGES_NS[np.clip(b, 0, N_LAT_BUCKETS - 2)]


@dataclasses.dataclass(frozen=True)
class LatencySpec:
    """Build parameters of the tail-latency tap.

    ``ops`` sizes the per-seed op columns: every client op id lies in
    [0, ops). ``phases`` and ``phase_ns`` cut the run into measurement
    windows: an op belongs to the window its invoke fell in, and the
    last window is open-ended, so a p99 blowup inside one fault window
    is that window's histogram. Hashable, like every build flag."""

    ops: int
    phases: int = 1
    phase_ns: int = 1 << 27  # about 134 ms

    def __post_init__(self):
        if self.ops < 1:
            raise ValueError(f"LatencySpec.ops must be >= 1, got {self.ops}")
        if self.phases < 1:
            raise ValueError(f"LatencySpec.phases must be >= 1, got {self.phases}")
        if self.phase_ns < 1:
            raise ValueError(f"LatencySpec.phase_ns must be >= 1, got {self.phase_ns}")


# Client-retry op tokens: a retried op rides the same user kind with the
# attempt id in the token's high bits. Without a retry policy every
# attempt is 0, so every token is its plain op id; the army handlers
# strip tokens all the same.
RETRY_ATTEMPT_SHIFT = 26
RETRY_ATTEMPT_MAX = 15  # attempt ids 0..15 in bits 26..29
RETRY_OP_MASK = (1 << RETRY_ATTEMPT_SHIFT) - 1


def retry_token(op, attempt):
    """Pack (op id, attempt id) into an op token."""
    return op | (attempt << RETRY_ATTEMPT_SHIFT)


def retry_token_op(token):
    """The plain op id of a token (the identity on attempt-0 tokens)."""
    return token & RETRY_OP_MASK


def retry_token_attempt(token):
    """The attempt id of a token (0 for a plain op id)."""
    return (token >> RETRY_ATTEMPT_SHIFT) & RETRY_ATTEMPT_MAX


# backoff entries are clipped on the host so that the jitter product
# (entry * uint32 draw) stays inside int64: cap * 2^32 < 2^63
_RETRY_BACKOFF_CAP = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class RetrySpec:
    """Build parameters of the engine's client-retry timer mechanism.

    The compiled form of ``chaos.RetryPolicy`` attached to a
    ``ClientArmy``: ``kind``/``node``/``op_base``/``n_ops`` identify the
    army's offered ops (one retry-state slot per op), the policy fields
    drive the timers. Each delivered army attempt arms one follow-up
    pool row at ``now + timeout_ns + backoff + jitter`` with the attempt
    id incremented; when it pops, the op is delivered again unless a
    response was recorded meanwhile (the op's ``lat_end`` marker, which
    is why a retry build needs ``Workload.lat_markers``).
    ``max_attempts`` counts deliveries: the row carrying attempt id
    ``max_attempts`` is the give-up sentinel, which never delivers and
    only closes the books (``MET_RETRY_GIVEUP``). The backoff before
    attempt ``a >= 1`` is ``backoff_base_ns * backoff_mult**(a-1)``,
    jittered by a ``PURPOSE_RETRY`` draw scaled to ``[0, jitter]`` of
    the backoff, per (seed, step). Hashable, like every build flag."""

    kind: int
    node: int
    op_base: int
    n_ops: int
    timeout_ns: int
    max_attempts: int = 3
    backoff_base_ns: int = 0
    backoff_mult: float = 2.0
    jitter: float = 0.0

    def __post_init__(self):
        if self.n_ops < 1:
            raise ValueError(f"RetrySpec.n_ops must be >= 1, got {self.n_ops}")
        if self.timeout_ns < 1:
            raise ValueError(
                f"RetrySpec.timeout_ns must be >= 1, got {self.timeout_ns}"
            )
        if not (1 <= self.max_attempts <= RETRY_ATTEMPT_MAX):
            raise ValueError(
                f"RetrySpec.max_attempts must be in 1..{RETRY_ATTEMPT_MAX} "
                f"(the token packs attempts into 4 bits), got "
                f"{self.max_attempts}"
            )
        if self.op_base < 0:
            raise ValueError(
                f"RetrySpec.op_base must be >= 0, got {self.op_base}"
            )
        if self.op_base + self.n_ops - 1 > RETRY_OP_MASK:
            raise ValueError(
                f"RetrySpec op ids reach {self.op_base + self.n_ops - 1}, "
                f"past the {RETRY_ATTEMPT_SHIFT}-bit token op field "
                f"(max {RETRY_OP_MASK})"
            )
        if not (FIRST_USER_KIND <= self.kind < FIRST_EXT_KIND):
            raise ValueError(
                f"RetrySpec.kind={self.kind} must be a user kind "
                f"(in [{FIRST_USER_KIND}, {FIRST_EXT_KIND}))"
            )
        if self.backoff_base_ns < 0:
            raise ValueError(
                f"RetrySpec.backoff_base_ns must be >= 0, got "
                f"{self.backoff_base_ns}"
            )
        if self.backoff_mult < 1.0:
            raise ValueError(
                f"RetrySpec.backoff_mult must be >= 1, got "
                f"{self.backoff_mult}"
            )
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(
                f"RetrySpec.jitter must be in [0, 1], got {self.jitter}"
            )


def _retry_backoff_tables(rt: RetrySpec):
    """The backoff tables, indexed by the next attempt id: entry ``a`` is
    the backoff before delivering attempt ``a`` and the jitter table the
    largest jitter addend (``backoff * jitter``), both clipped to the
    int64-safe cap. Python float arithmetic, as the reference's, so the
    integers are the same."""
    boff = [0]
    for a in range(1, rt.max_attempts + 1):
        b = rt.backoff_base_ns * rt.backoff_mult ** (a - 1)
        boff.append(min(int(b), _RETRY_BACKOFF_CAP))
    bjit = [min(int(b * rt.jitter), _RETRY_BACKOFF_CAP) for b in boff]
    return tuple(boff), tuple(bjit)


def _check_retry(wl: "Workload", retry: "RetrySpec | None") -> int:
    """Validate a retry build parameter; returns n_ops (0 = off). Shared
    by :func:`make_init` and the steps."""
    if retry is None:
        return 0
    if not isinstance(retry, RetrySpec):
        raise TypeError(
            f"retry must be a RetrySpec or None, got {type(retry).__name__}"
        )
    if wl.lat_markers == 0:
        raise ValueError(
            "retry needs a workload with latency markers "
            "(Workload.lat_markers > 0): the response-deadline timer is "
            "disarmed by the op's lat_end marker, so a model that never "
            "marks responses would retry forever"
        )
    return retry.n_ops


_TRACE_PRIME = 0x100000001B3
_TRACE_MIX = 0x9E3779B97F4A7C15 - (1 << 64)  # as an int64 bit pattern


def user_kind(i: int) -> int:
    """Kind id of user handler ``i`` (handler 0 = on_init)."""
    return FIRST_USER_KIND + i


def pack_slow_arg(b, mult):
    """A slow-link peer and multiplier in one int32 args word: the low
    byte is the peer + 1 (0 = node-wide), bits 8 and up the multiplier.
    Takes Python ints, numpy arrays (the plan compiler) and tensors (a
    handler's emits)."""
    if isinstance(b, (int, np.integer)) and isinstance(mult, (int, np.integer)):
        return ((int(b) + 1) & 0xFF) | (int(mult) << 8)
    if isinstance(b, np.ndarray) or isinstance(mult, np.ndarray):
        return ((np.asarray(b, np.int64) + 1) & 0xFF) | (np.asarray(mult, np.int64) << 8)
    b = torch.as_tensor(b).to(torch.int32)
    if isinstance(mult, (int, np.integer)):
        # a host multiplier stays a scalar operand: no copy to the device
        return ((b + 1) & 0xFF) | (int(mult) << 8)
    return ((b + 1) & 0xFF) | (torch.as_tensor(mult, device=b.device).to(torch.int32) << 8)


def unpack_slow_arg(word: int) -> tuple:
    """Inverse of :func:`pack_slow_arg` for host ints: ``(peer, mult)``,
    peer -1 meaning node-wide."""
    return (int(word) & 0xFF) - 1, int(word) >> 8


def set_cols(state: torch.Tensor, cond, cols: dict) -> torch.Tensor:
    """A copy of the ``(S, U)`` rows ``state`` with ``cols`` (``{column:
    value}``) written where ``cond`` holds: a handler's
    ``jnp.where(cond, st.at[c].set(v)..., st)``, batched."""
    new = state.clone()
    for c, v in cols.items():
        new[:, c] = torch.where(cond, v, state[:, c])
    return new


def get_col(state: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Column ``col[i]`` of each row ``i`` of the ``(S, U)`` rows
    ``state``: a handler's ``st[c]`` with a computed ``c``, batched."""
    return state.gather(1, col.long()[:, None])[:, 0]


def set_col(state: torch.Tensor, col: torch.Tensor, v, cond=None) -> torch.Tensor:
    """A copy of the ``(S, U)`` rows ``state`` with ``v`` written at
    column ``col[i]`` of each row ``i`` (where ``cond`` holds): a
    handler's ``st.at[c].set(v)`` with a computed ``c``, batched."""
    if cond is not None:
        v = torch.where(cond, v, get_col(state, col))
    return state.scatter(1, col.long()[:, None], v.to(state.dtype)[:, None])


# ---------------------------------------------------------------------------
# ev_meta: kind | (node+1) << 8 | (src+1) << 16 | retry << 24, one uint32
# word per slot (carried in int64). Out-of-range kinds and nodes are
# clipped at pack time to values that match nothing downstream.
# ---------------------------------------------------------------------------


def _meta_pack(kind, node1, src1, retry):
    return (
        kind.to(torch.int64)
        | (node1.to(torch.int64) << 8)
        | (src1.to(torch.int64) << 16)
        | (retry.to(torch.int64) << 24)
    )


def _meta_kind(meta):
    return (meta & 0xFF).to(torch.int32)


def _meta_node(meta):
    return ((meta >> 8) & 0xFF).to(torch.int32) - 1


def _meta_src(meta):
    return ((meta >> 16) & 0xFF).to(torch.int32) - 1


def _meta_retry(meta):
    return ((meta >> 24) & 0xFF).to(torch.int32)


def _check_meta_ranges(wl: "Workload") -> None:
    if wl.n_nodes > 254:
        raise ValueError(
            f"n_nodes={wl.n_nodes} exceeds the meta byte range (254)"
        )
    if FIRST_USER_KIND + len(wl.handlers) > FIRST_EXT_KIND:
        raise ValueError(
            f"{len(wl.handlers)} handlers exceed the user kind range "
            f"[{FIRST_USER_KIND}, {FIRST_EXT_KIND})"
        )


def _wrap64(v: int) -> int:
    """A Python int as the int64 with the same low 64 bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def _trace_fold(trace, now, kind, node, args, pay):
    """Fold one dispatched event into the rolling trace hash.

    uint64 arithmetic on int64 bit patterns: products and sums wrap
    mod 2^64 alike, and a left shift by a multiply keeps the low bits.
    """
    h = now * _TRACE_MIX
    h = h ^ (kind.to(torch.int64) << 32)
    # node sign-extends like the reference's int32 -> uint64 cast;
    # multiply instead of shifting a negative value
    h = h ^ (node.to(torch.int64) * (1 << 40))
    a = args.to(torch.int64) & M32
    for j in range(args.shape[-1]):
        h = h ^ (a[..., j] << (8 * j))
    if pay.shape[-1] > 0:
        p = pay.to(torch.int64) & M32
        mix = torch.tensor(
            [_wrap64(0x9E3779B97F4A7C15 ^ j) for j in range(pay.shape[-1])],
            dtype=torch.int64, device=pay.device,
        )
        h = h ^ (p * mix).sum(-1)
    return trace * _TRACE_PRIME + h


# ---------------------------------------------------------------------------
# configuration and the workload API
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static simulation parameters; ``hash()`` equals the JAX package's
    for the same values (same fields, same order, same repr)."""

    pool_size: int = 256  # E: max in-flight events per seed
    lat_min_ns: int = 1_000_000  # network latency range, default 1-10 ms
    lat_max_ns: int = 10_000_000
    loss_p: float = 0.0  # packet loss rate
    proc_min_ns: int = 50  # per-event processing cost
    proc_max_ns: int = 100
    clog_backoff_min_ns: int = 1_000_000  # clogged-delivery recheck backoff
    clog_backoff_max_ns: int = 10_000_000_000
    time_limit_ns: int = 0  # 0 = unlimited

    def __post_init__(self):
        for lo, hi, what in (
            (self.lat_min_ns, self.lat_max_ns, "latency"),
            (self.proc_min_ns, self.proc_max_ns, "processing-cost"),
        ):
            if hi < lo:
                raise ValueError(f"{what} range [{lo}, {hi}) is empty")
            if hi - lo > DRAW_SPAN_MAX:
                raise ValueError(
                    f"{what} span {hi - lo} ns does not fit uint32 "
                    f"(max {DRAW_SPAN_MAX} ns, ~4.29 s)"
                )

    @property
    def loss_u32(self) -> int:
        return chance_threshold(self.loss_p)

    @property
    def time_limit(self) -> int:
        """The absolute clock bound the step compares against."""
        return self.time_limit_ns if self.time_limit_ns else _INF_NS

    def hash(self) -> str:
        """Stable hex hash of the config."""
        s = repr(dataclasses.astuple(self)).encode()
        return hashlib.sha256(s).hexdigest()[:16]


@dataclasses.dataclass
class Emits:
    """A handler's events over a batch: ``(S, K)`` rows.

    ``send`` rows become network deliveries (latency, loss, clog);
    timer rows become plain future events after ``delay``.
    """

    valid: torch.Tensor  # (S,K) bool
    send: torch.Tensor  # (S,K) bool
    kind: torch.Tensor  # (S,K) int32
    dst: torch.Tensor  # (S,K) int32
    delay: torch.Tensor  # (S,K) int64 ns (timers)
    args: torch.Tensor  # (S,K,A) int32
    pay: torch.Tensor  # (S,K,W) int32
    # operation-history records (R = HistorySpec.max_records, 0 = off):
    # each row is (op, key, arg, ok); the engine stamps the client node
    # and the dispatch time when it appends them to the history columns
    rec_valid: torch.Tensor | None = None  # (S,R) bool
    rec: torch.Tensor | None = None  # (S,R,4) int32
    # the dispatch's fsync (Workload.durable_sync): the OR of the
    # handler's sync() calls; ignored without the discipline
    sync: torch.Tensor | None = None  # (S,) bool
    # latency markers (L = Workload.lat_markers, 0 = off): each row is
    # (op id, phase), phase 0 an invoke (EmitBuilder.lat_start) and 1 a
    # response (lat_end); the step stamps the dispatch clock into the
    # latency columns, and ignores the rows with the tap off
    lat_valid: torch.Tensor | None = None  # (S,L) bool
    lat: torch.Tensor | None = None  # (S,L,2) int32


class EmitBuilder:
    """Collects a handler's emits; slot order is call order, and
    ``when`` (a bool or an ``(S,)`` tensor) makes a row conditional.
    History records (``record``) and latency markers (``lat_start``,
    ``lat_end``) keep their own call orders."""

    def __init__(self, k: int, w: int, a: int, s: int, device, r: int = 0, l: int = 0):
        self._k, self._w, self._a, self._s, self._r, self._l = k, w, a, s, r, l
        self._device = device
        self._rows: list[tuple] = []
        self._recs: list[tuple] = []
        self._syncs: list = []
        self._lats: list[tuple] = []

    def _col(self, x, dtype):
        t = torch.as_tensor(x, device=self._device).to(dtype)
        return t.expand(self._s) if t.dim() == 0 else t

    def _push(self, send, kind, dst, delay, args, when, pay=()):
        if len(self._rows) >= self._k:
            raise ValueError(
                f"handler emits more than max_emits={self._k} events; "
                f"raise Workload.max_emits"
            )
        if len(args) > self._a:
            raise ValueError(
                f"{len(args)} event args exceed Workload.args_words={self._a}"
            )
        if len(pay) > self._w:
            raise ValueError(
                f"payload of {len(pay)} words exceeds "
                f"Workload.payload_words={self._w}"
            )
        a = list(args) + [0] * (self._a - len(args))
        p = list(pay) + [0] * (self._w - len(pay))
        self._rows.append((when, send, kind, dst, delay, a, p))

    def send(self, dst, kind, args=(), when=True, pay=()):
        """Send a network message: delivery after latency unless lost,
        clogged or the destination is dead."""
        self._push(True, kind, dst, 0, args, when, pay)

    def after(self, delay_ns, kind, dst, args=(), when=True, pay=()):
        """Schedule a local event ``delay_ns`` in the future (a timer)."""
        self._push(False, kind, dst, delay_ns, args, when, pay)

    def kill(self, node, when=True):
        self.after(0, KIND_KILL, 0, (node,), when)

    def restart(self, node, when=True):
        self.after(0, KIND_RESTART, 0, (node,), when)

    def restart_after(self, delay_ns, node, when=True):
        self.after(delay_ns, KIND_RESTART, 0, (node,), when)

    def pause(self, node, when=True):
        self.after(0, KIND_PAUSE, 0, (node,), when)

    def resume(self, node, when=True):
        self.after(0, KIND_RESUME, 0, (node,), when)

    def clog_link(self, a, b, when=True):
        self.after(0, KIND_CLOG, 0, (a, b), when)

    def unclog_link(self, a, b, when=True):
        self.after(0, KIND_UNCLOG, 0, (a, b), when)

    def clog_link_one_way(self, src, dst, when=True):
        """Asymmetric partition edge: block src -> dst only."""
        self.after(0, KIND_CLOG_1W, 0, (src, dst), when)

    def unclog_link_one_way(self, src, dst, when=True):
        self.after(0, KIND_UNCLOG_1W, 0, (src, dst), when)

    def slow_link(self, a, b, mult, when=True):
        """Gray failure: a<->b latency times ``mult`` (b=-1 slows every
        link in or out of a)."""
        self.after(0, KIND_SLOW_LINK, 0, (a, pack_slow_arg(b, mult)), when)

    def unslow_link(self, a, b, when=True):
        self.after(0, KIND_UNSLOW, 0, (a, pack_slow_arg(b, 1)), when)

    def dup_on(self, when=True):
        """Start duplicating messages (needs ``dup_rows=True``)."""
        self.after(0, KIND_DUP_ON, 0, (), when)

    def dup_off(self, when=True):
        self.after(0, KIND_DUP_OFF, 0, (), when)

    def set_skew(self, node, skew_ns, when=True):
        """Set the node's clock skew: its handlers observe now+skew_ns."""
        self.after(0, KIND_SKEW, 0, (node, skew_ns), when)

    def sync(self, when=True):
        """fsync the handling node's durable columns (``Workload.durable_sync``):
        this dispatch's durable writes are committed to the node's disk
        image, unless a ``KIND_SYNC_LOSS`` window makes the disk lie or
        fail. A no-op without the discipline."""
        self._syncs.append(when)

    # the disk-fault kinds: engine events that change no state on a
    # workload without the sync discipline
    def sync_loss(self, node, when=True):
        self.after(0, KIND_SYNC_LOSS, 0, (node,), when)

    def sync_eio(self, node, when=True):
        self.after(0, KIND_SYNC_LOSS, 0, (node, 1), when)

    def sync_ok(self, node, when=True):
        self.after(0, KIND_SYNC_OK, 0, (node,), when)

    def torn_on(self, node, when=True):
        self.after(0, KIND_TORN_ON, 0, (node,), when)

    def torn_off(self, node, when=True):
        self.after(0, KIND_TORN_OFF, 0, (node,), when)

    def halt(self, when=True):
        self.after(0, KIND_HALT, 0, (), when)

    def record(self, op, key=0, arg=0, ok=1, when=True):
        """Append one operation-history record.

        ``op``, ``key`` and ``arg`` are workload-defined int32 words;
        ``ok`` follows the ``check.history`` convention (-1 = invoke of
        a pending operation, 1 = successful response, 0 = failed
        response). The engine stamps the record with the handling node
        (the client column) and the dispatch time. Requires
        ``Workload.history``.
        """
        if self._r == 0:
            raise ValueError(
                "record() needs history slots; set Workload.history to a "
                "HistorySpec (and size its max_records)"
            )
        if len(self._recs) >= self._r:
            raise ValueError(
                f"handler records more than max_records={self._r} history "
                f"entries; raise HistorySpec.max_records"
            )
        self._recs.append((when, op, key, arg, ok))

    def _lat_mark(self, op_id, phase: int, when) -> None:
        if self._l == 0:
            raise ValueError(
                "lat_start/lat_end need latency marker slots; set "
                "Workload.lat_markers (the per-invocation marker count)"
            )
        if len(self._lats) >= self._l:
            raise ValueError(
                f"handler marks more than lat_markers={self._l} latency "
                f"ops; raise Workload.lat_markers"
            )
        self._lats.append((when, op_id, phase))

    def lat_start(self, op_id, when=True):
        """Mark the invoke of client op ``op_id``: the step stamps this
        dispatch's clock into ``lat_inv[op_id]``. The first start wins.
        Derived state only: with the latency tap off the marker changes
        nothing."""
        self._lat_mark(op_id, 0, when)

    def lat_end(self, op_id, when=True):
        """Mark the response of client op ``op_id``: the step stamps
        ``lat_resp[op_id]`` and folds the op's latency into the seed's
        sketch (``lat_hist``). The first response wins (a duplicated
        delivery counts once); an end without a start is ignored."""
        self._lat_mark(op_id, 1, when)

    def _cols(self, vals: list, dtype, width: int) -> torch.Tensor:
        """``(S, width)`` of ``dtype``: column ``j`` holds ``vals[j]``
        (a Python scalar or a tensor, converted as :meth:`_col` does),
        zeros past ``len(vals)``. A few ops whatever the row count."""
        s, dev = self._s, self._device
        if width == 0:
            return torch.zeros((s, 0), dtype=dtype, device=dev)
        arrays = (torch.Tensor, np.ndarray)
        tens = [j for j, v in enumerate(vals) if isinstance(v, arrays)]
        if len(tens) == width:
            return torch.stack([self._col(v, dtype) for v in vals], 1)
        scal = [0 if isinstance(v, arrays) else v for v in vals]
        scal += [0] * (width - len(vals))
        out = torch.tensor(scal, dtype=torch.int64, device=dev).to(dtype).expand(s, width)
        if tens:
            out = out.clone()
            out[:, tens] = torch.stack([self._col(vals[j], dtype) for j in tens], 1)
        return out

    def build(self) -> Emits:
        s, k, a_w, w = self._s, self._k, self._a, self._w
        rows = self._rows
        col = lambda i, dt: self._cols([r[i] for r in rows], dt, k)  # noqa: E731
        valid = col(0, torch.bool)
        send = col(1, torch.bool)
        kind = col(2, torch.int32)
        dst = col(3, torch.int32)
        delay = col(4, torch.int64)
        args = self._cols([x for r in rows for x in r[5]], torch.int32, k * a_w)
        pay = self._cols([x for r in rows for x in r[6]], torch.int32, k * w)
        recs = self._recs
        rec_valid = self._cols([r[0] for r in recs], torch.bool, self._r)
        rec = self._cols([x for r in recs for x in r[1:]], torch.int32, self._r * 4)
        sync = self._cols(list(self._syncs), torch.bool, len(self._syncs)).any(1)
        lats = self._lats
        lat_valid = self._cols([r[0] for r in lats], torch.bool, self._l)
        lat = self._cols([x for r in lats for x in r[1:]], torch.int32, self._l * 2)
        return Emits(valid, send, kind, dst, delay, args.view(s, k, a_w), pay.view(s, k, w),
                     rec_valid, rec.view(s, self._r, 4), sync, lat_valid,
                     lat.view(s, self._l, 2))


@dataclasses.dataclass(frozen=True)
class HistorySpec:
    """Per-seed operation-history recording (the ``check`` package).

    Histories are fixed-size columns of the state, kept like the trace
    hash: ``capacity`` slots per seed, each one record of (op, key, arg,
    client, ok) int32 words and an int64 sim-time. Handlers append
    records through :meth:`EmitBuilder.record`; a full buffer never
    drops silently: overflow is counted in ``SimState.hist_drop`` and
    the checkers refuse such seeds.

    Sizing: one *operation* costs two records (an invoke and a
    response); an instantaneous event (an election win) costs one.
    ``max_records`` is the per-handler-call slot count (the history
    analog of ``max_emits``).
    """

    capacity: int
    max_records: int = 2

    def __post_init__(self):
        if self.capacity < 1:
            raise ValueError(f"history capacity must be >= 1, got {self.capacity}")
        if self.max_records < 1:
            raise ValueError(
                f"max_records must be >= 1, got {self.max_records}"
            )


@dataclasses.dataclass
class HandlerCtx:
    """What a handler sees about the events it processes, one row per
    seed."""

    now: torch.Tensor  # (S,) int64 virtual clock (plus the node's skew)
    node: torch.Tensor  # (S,) int32 the node the event targets
    state: torch.Tensor  # (S,U) int32 the node's state row
    args: torch.Tensor  # (S,A) int32 event arguments
    src: torch.Tensor  # (S,) int32 sender node, -1 for timers
    draw: Draw  # counter-based RNG for this event
    max_emits: int
    payload: torch.Tensor  # (S,W) int32
    payload_words: int = 0
    args_words: int = 4
    max_records: int = 0  # history record slots (Workload.history)
    lat_markers: int = 0  # latency marker slots (Workload.lat_markers)
    # (S,) bool: the node is inside an injected fsync-EIO window
    # (KIND_SYNC_LOSS with args[1] = 1), the pre-dispatch flag; always
    # False without the sync discipline
    sync_err: torch.Tensor | None = None

    def emits(self) -> EmitBuilder:
        return EmitBuilder(
            self.max_emits, self.payload_words, self.args_words,
            self.state.shape[0], self.state.device, self.max_records,
            self.lat_markers,
        )


Handler = Callable[[HandlerCtx], tuple]


@dataclasses.dataclass(frozen=True)
class Workload:
    """A batched simulation program: per-node int32 state plus handlers.

    ``handler(ctx) -> (new_state (S,U), Emits)``; handler 0 is on_init,
    run for every node at t=0 and again after a restart.
    ``model_params`` names the factory's parameters, which a fused
    kernel that carries the handlers as device code needs. ``history``
    turns on operation-history recording (:class:`HistorySpec`).
    ``durable_sync`` puts ``durable_cols`` under the two-phase sync
    discipline: a durable write survives a kill only up to the node's
    last committed :meth:`EmitBuilder.sync`. A workload that syncs every
    durable write in the dispatch that made it runs the same trajectory
    as without the discipline, as long as no disk fault is injected.
    """

    name: str
    n_nodes: int
    state_width: int
    handlers: tuple
    max_emits: int = 8
    init_state: np.ndarray | None = None  # (N,U) int32; zeros if None
    payload_words: int = 0
    args_words: int = 4
    durable_cols: tuple | None = None
    # user purposes generated in the step's batched RNG block
    draw_purposes: tuple | None = None
    model_params: tuple = ()  # ((name, value), ...)
    history: HistorySpec | None = None
    durable_sync: bool = False
    # protocol-specific coverage features: ``cov_features(node_state
    # (S,N,U), now (S,)) -> iterable of (feature, on)`` pairs, a feature
    # an (S,) word (its low 24 bits are hashed under the engine's tag 6)
    # and ``on`` an (S,) bool or a bool (ANDed with the user-dispatch
    # gate). Evaluated once per step over the post-dispatch fleet state
    # when the step runs the coverage taps; it changes bitmaps only.
    cov_features: Callable | None = None
    # latency marker slots per handler call (EmitBuilder.lat_start and
    # lat_end); 0 keeps the Emits free of marker rows. The markers
    # change nothing unless the step is built with a LatencySpec.
    lat_markers: int = 0
    # optional human names for the user handlers (len == len(handlers)),
    # read only by timelines, Perfetto documents and ``obs.explain``: no
    # effect on execution
    handler_names: tuple | None = None
    # the largest timer delay (ns) a handler passes to EmitBuilder.after,
    # None when unknown: read only by column_contracts, which bounds the
    # pool clock by it
    delay_bound_ns: int | None = None
    # per-column range declarations, one StateContract per state column
    # (TOTAL over state_width when present): column_contracts narrows the
    # node_state contract to their hull. None keeps the full int32 range
    state_contracts: tuple | None = None

    def __post_init__(self):
        if self.handler_names is not None and len(self.handler_names) != len(self.handlers):
            raise ValueError(
                f"handler_names has {len(self.handler_names)} entries for "
                f"{len(self.handlers)} handlers — replay timelines would "
                f"label the wrong handlers"
            )
        if not (2 <= self.args_words <= 4):
            raise ValueError(
                f"args_words={self.args_words} must be in [2, 4] "
                f"(engine kinds read args[0:2])"
            )
        limit = PURPOSE_LOSS - PURPOSE_LATENCY - 1
        if self.max_emits > limit:
            raise ValueError(
                f"max_emits={self.max_emits} exceeds the purpose-namespace "
                f"limit of {limit}"
            )
        if self.durable_cols is not None:
            bad = [c for c in self.durable_cols if not 0 <= c < self.state_width]
            if bad:
                raise ValueError(
                    f"durable_cols {bad} out of range for "
                    f"state_width={self.state_width}"
                )
        if self.durable_sync and not self.durable_cols:
            raise ValueError(
                "durable_sync needs durable_cols: the sync discipline "
                "governs exactly the columns that survive a kill"
            )
        if self.lat_markers < 0:
            raise ValueError(f"lat_markers must be >= 0, got {self.lat_markers}")
        for p in self.draw_purposes or ():
            if not 0 <= int(p) < lane("user").width:
                raise ValueError(
                    f"draw_purposes purpose {p} is outside the user lane"
                )
        if self.state_contracts is not None:
            cols = sorted(sc.col for sc in self.state_contracts)
            if cols != list(range(self.state_width)):
                raise ValueError(
                    f"state_contracts must declare every state column "
                    f"exactly once (expected cols 0..{self.state_width - 1}, "
                    f"got {cols}) — a partial declaration would silently "
                    f"weaken the node_state hull"
                )
            bad = [
                sc.col for sc in self.state_contracts
                if not (-(2 ** 31) <= sc.lo <= sc.hi <= 2 ** 31 - 1)
            ]
            if bad:
                raise ValueError(
                    f"state_contracts columns {bad} declare ranges that "
                    f"are empty or exceed int32"
                )

    def initial_state(self) -> np.ndarray:
        if self.init_state is not None:
            return np.asarray(self.init_state, np.int32)
        return np.zeros((self.n_nodes, self.state_width), np.int32)

    def volatile_mask(self) -> np.ndarray:
        """(U,) bool — True where RESTART resets to the initial row."""
        mask = np.ones((self.state_width,), bool)
        if self.durable_cols:
            mask[list(self.durable_cols)] = False
        return mask


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimState:
    """Every seed's simulation state; the leading axis is the seed."""

    seed: torch.Tensor  # (S,) int64: uint64 instance seed bits
    now: torch.Tensor  # (S,) int64 virtual clock, ns
    step: torch.Tensor  # (S,) int64: uint32 event sequence number
    halted: torch.Tensor  # (S,) bool
    halt_time: torch.Tensor  # (S,) int64 clock when halted (else 0)
    trace: torch.Tensor  # (S,) int64: uint64 rolling hash bits
    overflow: torch.Tensor  # (S,) int32 events dropped to pool overflow
    msg_count: torch.Tensor  # (S,) int64 messages sent
    ev_time: torch.Tensor  # (S,E) int64 absolute ns
    ev_valid: torch.Tensor  # (S,E) bool
    ev_meta: torch.Tensor  # (S,E) int64: uint32 packed kind/node/src/retry
    ev_epoch: torch.Tensor  # (S,E) int32 target-node epoch at emit time
    ev_args: torch.Tensor  # (S,E,A) int32
    ev_pay: torch.Tensor  # (S,E,W) int32
    alive: torch.Tensor  # (S,N) bool
    paused: torch.Tensor  # (S,N) bool
    epoch: torch.Tensor  # (S,N) int32
    node_state: torch.Tensor  # (S,N,U) int32
    clog: torch.Tensor  # (S,N,N) bool link-clog matrix
    slow: torch.Tensor  # (S,N,N) int32 latency multiplier, identity 1
    dup: torch.Tensor  # (S,) bool message duplication, identity False
    skew: torch.Tensor  # (S,N) int32 clock skew ns, identity 0
    # the two-phase sync discipline, D = N with Workload.durable_sync,
    # else 0: each node's last synced image of its durable columns (a
    # kill reverts them to it), the columns of its last uncommitted
    # durable write (the one a torn kill tears), and its chaos windows
    disk: torch.Tensor  # (S,D,U) int32
    wmask: torch.Tensor  # (S,D,U) bool
    sync_loss: torch.Tensor  # (S,D) bool: syncs lie (KIND_SYNC_LOSS, args[1]=0)
    sync_eio: torch.Tensor  # (S,D) bool: syncs fail observably (args[1]=1)
    torn: torch.Tensor  # (S,D) bool: torn-write mode armed (KIND_TORN_ON)
    # operation history, H = HistorySpec.capacity (0 when
    # Workload.history is None): rows in append (dispatch) order;
    # hist_drop counts records lost to a full buffer, and a nonzero
    # value voids the seed's history verdict
    hist_count: torch.Tensor  # (S,) int32 records stored
    hist_drop: torch.Tensor  # (S,) int32 records dropped at capacity
    hist_word: torch.Tensor  # (S,H,5) int32 [op, key, arg, client, ok]
    hist_t: torch.Tensor  # (S,H) int64 record sim-time ns (absolute)
    # the fleet counters (metrics=True), the MET_* slots; (S,0) when off
    met: torch.Tensor  # (S,N_METRICS) int32
    # the coverage fingerprint, CW = cov_words (0 = off, zero-size): each
    # dispatch folds behavior features into a CW*32-bit bitmap; with
    # cov_hitcount a saturating counter per bit position keys each
    # feature's bit by its hit-count class. Derived state only.
    cov: torch.Tensor  # (S,CW) int64: uint32 bitmap words
    cov_last: torch.Tensor  # (S,N) int32 last user kind per node (CW > 0), else (S,0)
    cov_hits: torch.Tensor  # (S,CW*32) uint8 with cov_hitcount, else (S,0)
    # the timeline ring, T = timeline_cap (0 = off, zero-size): one row
    # per dispatch, the tuple the trace hash folds, in dispatch order; a
    # full ring counts its drops in tl_drop and never voids a verdict
    tl_count: torch.Tensor  # (S,) int32 rows recorded
    tl_drop: torch.Tensor  # (S,) int32 rows dropped at capacity
    tl_t: torch.Tensor  # (S,T) int64 dispatch clock ns (unskewed)
    tl_meta: torch.Tensor  # (S,T) int64: uint32 packed meta of the row
    tl_args: torch.Tensor  # (S,T,A) int32
    tl_pay: torch.Tensor  # (S,T,W) int32
    # the emit-time sidecar (T > 0, else zero-size): the clock at which
    # each pool row was inserted (0 for init and plan rows), copied into
    # tl_emit when the row is dispatched; a clog reschedule keeps it
    ev_emit: torch.Tensor  # (S,E) int64
    tl_emit: torch.Tensor  # (S,T) int64
    # causal provenance (causal=True, else zero-size): each node's Lamport
    # clock, folded at dispatch lam[dst] = max(lam[dst], lam at emit) + 1;
    # each pool row's emitting dispatch seq (or a PARENT_* class) and that
    # dispatch's folded clock, read at the pop as ev_emit is; and, with
    # the ring, each captured row's own seq, its parent's seq and its
    # folded clock. uint32 clocks in int64, masked to 32 bits
    lam: torch.Tensor  # (S,N) int64
    ev_parent: torch.Tensor  # (S,E) int32
    ev_lam: torch.Tensor  # (S,E) int64
    tl_seq: torch.Tensor  # (S,T) int32
    tl_parent: torch.Tensor  # (S,T) int32
    tl_lam: torch.Tensor  # (S,T) int64
    # the tail-latency tap, C = LatencySpec.ops and P = its phases (both
    # 0 when off, zero-size): each op's invoke and response clock (-1 =
    # not yet), the per-window ladder sketch of completed ops, their
    # count, and the markers whose op id lay outside [0, C)
    lat_inv: torch.Tensor  # (S,C) int64
    lat_resp: torch.Tensor  # (S,C) int64
    lat_hist: torch.Tensor  # (S,P,N_LAT_BUCKETS) int32, (S,0,0) when off
    lat_count: torch.Tensor  # (S,) int32
    lat_drop: torch.Tensor  # (S,) int32
    # the client-retry books, CR = RetrySpec.n_ops (0 without a policy,
    # zero-size): whether each op saw its response, its last delivered
    # attempt and its armed deadline (absolute ns)
    rt_done: torch.Tensor  # (S,CR) bool
    rt_attempt: torch.Tensor  # (S,CR) int32
    rt_deadline: torch.Tensor  # (S,CR) int64

    @property
    def device(self) -> torch.device:
        return self.seed.device

    def to(self, device) -> "SimState":
        return SimState(
            **{f.name: getattr(self, f.name).to(device) for f in _FIELDS}
        )


_FIELDS = dataclasses.fields(SimState)
STATE_FIELDS = tuple(f.name for f in _FIELDS)


# ---------------------------------------------------------------------------
# The derived-state manifest and the column range contracts, copied from
# the JAX package (engine/core.py), without its time32 branch and its
# pool-index columns (tile_min, tile_cnt), which the one lowering drops.
# The derived columns may be written by the step but nothing computed
# from them may reach a core column, a draw or the trace fold;
# lint.check_noninterference holds that by perturbing them within their
# contracts and requiring the core columns and the trace to stay equal.
# ---------------------------------------------------------------------------

# always derived, whatever the build flags; with the matching tap off
# they are zero-size, trivially non-interfering
DERIVED_STATE_FIELDS = (
    "hist_count", "hist_drop", "hist_word", "hist_t",
    "cov", "cov_last", "cov_hits",
    "met",
    "tl_count", "tl_drop", "tl_t", "tl_meta", "tl_args", "tl_pay",
    "ev_emit", "tl_emit",
    *CAUSAL_STATE_FIELDS,
    *LATENCY_FIELDS,
)


def derived_fields(wl: Workload) -> tuple:
    """SimState field names that are derived-only for this workload:
    :data:`DERIVED_STATE_FIELDS`, and the storage columns unless
    ``durable_sync`` is on (a kill then reads the disk image back into
    ``node_state``, a legitimate feedback path)."""
    out = DERIVED_STATE_FIELDS
    if not wl.durable_sync:
        out = out + STORAGE_FIELDS
    return out


def core_fields(wl: Workload) -> tuple:
    """Complement of :func:`derived_fields` over the SimState fields."""
    derived = set(derived_fields(wl))
    return tuple(f for f in STATE_FIELDS if f not in derived)


# Default certification horizon, the largest virtual clock the contracts
# bound time columns by when the config sets no time_limit_ns: 2^42 ns,
# some 73 sim-minutes; models declare their own (ABSINT_HORIZON_NS in
# models/*.py).
ABSINT_HORIZON_NS = 1 << 42
# Certified bound on unbounded counters (drops, message counts, metrics).
ABSINT_COUNTER_MAX = 1 << 30


@dataclasses.dataclass(frozen=True)
class ColumnContract:
    """Declared value range of one SimState column at step boundaries."""

    field: str
    lo: int
    hi: int
    family: str | None = None  # "time" | "counter" | None (untracked)
    note: str = ""


@dataclasses.dataclass(frozen=True)
class StateContract:
    """Declared range of one workload state column at step boundaries
    (``Workload.state_contracts``); the model owes its truth."""

    col: int
    lo: int
    hi: int
    family: str | None = None  # "time" | "counter" | None (untracked)
    note: str = ""


def _dtype_full(dt) -> tuple:
    info = np.iinfo(dt)
    return int(info.min), int(info.max)


def _node_state_contract(wl: Workload, i32: tuple) -> ColumnContract:
    """node_state's contract: full int32 and untracked, or the hull of
    the workload's ``state_contracts`` (tagged "time" if any column is)."""
    if not wl.state_contracts:
        return ColumnContract("node_state", *i32, None, "workload-defined words")
    lo = min(sc.lo for sc in wl.state_contracts)
    hi = max(sc.hi for sc in wl.state_contracts)
    families = {sc.family for sc in wl.state_contracts if sc.family}
    family = "time" if "time" in families else ("counter" if families else None)
    return ColumnContract(
        "node_state", lo, hi, family,
        f"hull of {len(wl.state_contracts)} declared state columns",
    )


def column_contracts(wl: Workload, cfg: EngineConfig, *,
                     horizon_ns: int | None = None) -> dict:
    """The per-column range contracts of one (workload, config): field
    name -> :class:`ColumnContract`, TOTAL over SimState (a column
    missing here raises). ``horizon_ns`` bounds the time columns
    (default: the config's ``time_limit_ns`` when set, else
    :data:`ABSINT_HORIZON_NS`). The ranges are the values' own (the
    JAX package's), whatever word the port stores them in: ``seed`` and
    ``trace`` are uint64, ``step`` and the packed meta words uint32."""
    if horizon_ns is None:
        horizon_ns = cfg.time_limit_ns or ABSINT_HORIZON_NS
    h = int(horizon_ns)
    cnt = ABSINT_COUNTER_MAX
    i32 = _dtype_full(np.int32)
    u32 = _dtype_full(np.uint32)
    u64 = _dtype_full(np.uint64)
    # the largest offset one insertion puts on the pool clock: a handler
    # timer, a slow-scaled latency draw or a clog-backoff reschedule
    delay_hi = wl.delay_bound_ns if wl.delay_bound_ns is not None else h
    offset_hi = max(
        int(delay_hi),
        int(cfg.lat_max_ns) * SLOW_MULT_MAX,
        int(cfg.clog_backoff_max_ns) + 1_000,
    )
    hcap = wl.history.capacity if wl.history is not None else 0

    def c(field, lo, hi, family=None, note=""):
        return ColumnContract(field, int(lo), int(hi), family, note)

    out = [
        c("seed", *u64),
        c("now", 0, h, "time"),
        c("step", 0, ABSINT_STEP_MAX, "counter", "RNG step coordinate"),
        c("halted", 0, 1),
        c("halt_time", 0, h, "time"),
        c("trace", *u64, None, "rolling hash, modular by design"),
        c("overflow", 0, cnt, "counter"),
        c("msg_count", 0, cnt, "counter"),
        c("ev_time", 0, h + offset_hi, "time", "absolute ns"),
        c("ev_valid", 0, 1),
        c("ev_meta", *u32, None, "packed kind/node/src/retry bytes"),
        c("ev_epoch", -1, cnt, "counter", "-1 = ANY-epoch sentinel"),
        c("ev_args", *i32),
        c("ev_pay", *i32),
        c("alive", 0, 1),
        c("paused", 0, 1),
        c("epoch", 0, cnt, "counter"),
        _node_state_contract(wl, i32),
        c("clog", 0, 1),
        c("slow", 0, SLOW_MULT_MAX, None, "link latency multiplier"),
        c("dup", 0, 1),
        c("skew", *i32, None, "per-node clock skew ns"),
        c("disk", *i32),
        c("wmask", 0, 1),
        c("sync_loss", 0, 1),
        c("sync_eio", 0, 1),
        c("torn", 0, 1),
        c("hist_count", 0, max(hcap, 0), "counter"),
        c("hist_drop", 0, cnt, "counter"),
        c("hist_word", *i32),
        c("hist_t", 0, h, "time"),
        c("cov", *u32, None, "bitmap words, modular folds"),
        c("cov_last", -1, 255),
        c("cov_hits", 0, 255),
        c("met", 0, cnt, "counter"),
        c("tl_count", 0, cnt, "counter"),
        c("tl_drop", 0, cnt, "counter"),
        c("tl_t", 0, h, "time"),
        c("tl_meta", *u32),
        c("tl_args", *i32),
        c("tl_pay", *i32),
        c("ev_emit", 0, h, "time"),
        c("tl_emit", 0, h, "time"),
        # the Lamport clocks grow by at most one a dispatch; parent seqs
        # are clamped copies of `step` with the sentinel classes below 0
        c("lam", 0, ABSINT_STEP_MAX, "counter", "per-node Lamport clock"),
        c("ev_parent", PARENT_ARMY, ABSINT_STEP_MAX, "counter",
          "emitting dispatch seq; -1/-2/-3 sentinel classes"),
        c("ev_lam", 0, ABSINT_STEP_MAX, "counter",
          "emitting dispatch's Lamport clock"),
        c("tl_seq", 0, ABSINT_STEP_MAX, "counter", "dispatch seq per row"),
        c("tl_parent", PARENT_ARMY, ABSINT_STEP_MAX, "counter",
          "parent seq per row; sentinel classes below zero"),
        c("tl_lam", 0, ABSINT_STEP_MAX, "counter"),
        c("lat_inv", -1, h, "time", "-1 = never invoked"),
        c("lat_resp", -1, h, "time", "-1 = incomplete"),
        c("lat_hist", 0, cnt, "counter"),
        c("lat_count", 0, cnt, "counter"),
        c("lat_drop", 0, cnt, "counter"),
        c("rt_done", 0, 1),
        c("rt_attempt", 0, RETRY_ATTEMPT_MAX, "counter",
          "delivered attempt id per op"),
        c("rt_deadline", 0, h + offset_hi + 2 * _RETRY_BACKOFF_CAP, "time",
          "absolute ns; armed response deadline per op"),
    ]
    contracts = {cc.field: cc for cc in out}
    missing = [f for f in STATE_FIELDS if f not in contracts]
    if missing:
        raise AssertionError(f"column_contracts is missing SimState fields: {missing}")
    return contracts


def resolve_device(device) -> torch.device:
    """``None`` means the card; raise rather than fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain step on the CPU"
        )
    return dev


def host_to_device(t: torch.Tensor, dev) -> torch.Tensor:
    """A host tensor on ``dev``. To the card it crosses from pinned
    memory without a wait: built inside a campaign's generation loop (a
    cold cache), a program must not wait for the card
    (``explore.device.strict_syncs``)."""
    if torch.device(dev).type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _seeds_tensor(seeds, device) -> torch.Tensor:
    if isinstance(seeds, torch.Tensor):
        return seeds.to(device=device, dtype=torch.int64)
    a = np.asarray(seeds)
    if a.dtype.kind == "i":
        a = a.astype(np.int64)
    else:
        a = a.astype(np.uint64).view(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


@dataclasses.dataclass
class PlanRows:
    """Per-seed fault-plan events as pre-seeded pool rows, from
    ``chaos.FaultPlan.compile_batch``: slot ``j`` of seed ``s`` becomes
    pool row ``n_nodes + j`` of the state ``make_init(plan_slots=P)``'s
    ``init(seeds, plan)`` builds. Invalid rows stay empty slots. Numpy
    arrays or tensors."""

    time: object  # (S, P) int64 absolute ns
    kind: object  # (S, P) int32 engine, extended-chaos or user kind
    args: object  # (S, P, 2) int32: engine kinds read args[0:2]
    valid: object  # (S, P) bool
    # the row's target node (a user-kind row's); None: every row
    # targets node 0, which engine kinds ignore
    node: object = None  # (S, P) int32, or None


def _plan_col(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.from_numpy(np.array(x, copy=True)).to(device=dev, dtype=dtype)


def _check_obs(cov_words: int, cov_hitcount: bool, timeline_cap: int,
               latency: "LatencySpec | None" = None) -> None:
    """The observability build parameters, checked alike by
    :func:`make_init` and the steps."""
    if latency is not None and not isinstance(latency, LatencySpec):
        raise TypeError(
            f"latency must be a LatencySpec or None, got {type(latency).__name__}"
        )
    if cov_words and (cov_words < 1 or cov_words & (cov_words - 1)):
        raise ValueError(
            f"cov_words={cov_words} must be 0 (off) or a power of two "
            f"(the feature hash reduces by bitmask)"
        )
    if cov_hitcount and not cov_words:
        raise ValueError(
            "cov_hitcount=True needs coverage enabled (cov_words > 0): "
            "hit-count buckets refine the coverage bitmap"
        )
    if timeline_cap < 0:
        raise ValueError(f"timeline_cap={timeline_cap} must be >= 0")


def obs_widths(state: SimState) -> tuple:
    """``(cov_words, cov_hitcount, timeline_cap)`` of the state's
    observability columns (the ``make_init`` arguments that built it)."""
    return (state.cov.shape[1], state.cov_hits.shape[1] > 0, state.tl_t.shape[1])


def check_obs_state(state: SimState, cov_words: int, cov_hitcount: bool,
                    timeline_cap: int) -> None:
    """Raise unless ``state``'s coverage and ring columns are those of a
    step built with these taps: a state from ``make_init`` with the same
    ``cov_words``, ``cov_hitcount`` and ``timeline_cap``."""
    want = (cov_words, bool(cov_hitcount), timeline_cap)
    if obs_widths(state) != want:
        raise ValueError(
            f"a step built with (cov_words, cov_hitcount, timeline_cap) = {want} "
            f"needs a state from make_init with the same arguments; this one has "
            f"{obs_widths(state)}"
        )


def lat_widths(state: SimState) -> tuple:
    """``(ops, phases)`` of the state's latency columns: the
    ``LatencySpec`` that built it, ``(0, 0)`` with the tap off."""
    return (state.lat_inv.shape[1], state.lat_hist.shape[1])


def check_lat_state(state: SimState, latency: "LatencySpec | None") -> None:
    """Raise unless ``state``'s latency columns are those of a step
    built with ``latency`` (a state from ``make_init`` with the same
    spec's ``ops`` and ``phases``, or none)."""
    want = (latency.ops, latency.phases) if latency is not None else (0, 0)
    if lat_widths(state) != want:
        raise ValueError(
            f"a step built with latency={latency} needs a state from make_init "
            f"with the same spec; this one has (ops, phases) = {lat_widths(state)}"
        )


def causal_on(state: SimState) -> bool:
    """Whether ``state`` carries the causal columns (``make_init(causal=
    True)``): its ``lam`` has a column per node."""
    return state.lam.shape[1] > 0


def check_causal_state(state: SimState, causal: bool, n: int) -> None:
    """Raise unless a step built with ``causal=True`` gets a state whose
    ``lam`` is ``(S, n)`` (the JAX package's shape guard)."""
    if causal and state.lam.shape[1] != n:
        raise ValueError(
            f"SimState.lam has shape {tuple(state.lam.shape[1:])} but this step "
            f"was built with causal=True (expects ({n},)); build "
            f"init/step with matching causal= values"
        )


def retry_width(state: SimState) -> int:
    """The op columns of ``state``'s retry books: the ``RetrySpec.n_ops``
    of the ``make_init`` that built it, 0 without a policy."""
    return state.rt_done.shape[1]


def check_retry_state(state: SimState, retry: "RetrySpec | None") -> None:
    """Raise unless ``state``'s retry columns are those of a step built
    with ``retry`` (a state from ``make_init`` with the same spec's
    ``n_ops``, or none)."""
    want = retry.n_ops if retry is not None else 0
    if retry_width(state) != want:
        raise ValueError(
            f"a step built with retry={retry} needs a state from make_init with "
            f"retry.n_ops={want}; this one has retry columns for "
            f"{retry_width(state)} ops"
        )


def make_init(wl: Workload, cfg: EngineConfig, device=None, plan_slots: int = 0,
              metrics: bool = False, cov_words: int = 0, timeline_cap: int = 0,
              cov_hitcount: bool = False, latency: "LatencySpec | None" = None,
              causal: bool = False, retry: "RetrySpec | None" = None):
    """Build ``init(seeds) -> SimState``: one on_init event per node at
    t=0 in slots ``0..N-1``, every other slot an invalid NOP.

    ``plan_slots=P`` reserves pool rows ``N..N+P-1`` for a compiled
    fault plan: ``init(seeds, plan)`` then needs a :class:`PlanRows`
    with ``(S, P)`` events. A plan row is a timer (no source); an
    engine or chaos row has epoch 0, a user-kind row epoch -1 (any
    incarnation of its target). ``metrics=True`` gives each seed its
    ``(N_METRICS,)`` counter row. Under the sync discipline a fresh
    node's disk holds its initial row. ``cov_words=CW`` (a power of
    two) sizes the coverage bitmap, ``cov_hitcount`` adds its hit
    counters, and ``timeline_cap=T`` the timeline ring and the emit-time
    sidecar; ``latency=LatencySpec(ops=C, phases=P)`` the per-op clocks
    (-1 until stamped) and the ``(P, N_LAT_BUCKETS)`` sketch.
    ``causal=True`` sizes the causal columns: ``lam`` and ``ev_lam`` start
    at 0, ``ev_parent`` at ``PARENT_NONE`` but for the plan rows, which
    take ``PARENT_ARMY`` where the row is a user kind (a client army's
    op) and ``PARENT_PLAN`` elsewhere; the ring's three causal columns
    get ``timeline_cap`` rows. ``retry=RetrySpec(...)`` sizes the retry
    books (``RETRY_STATE_FIELDS``, ``n_ops`` columns at False, 0 and 0);
    the plan rows do not change, an attempt-0 token being a plain op id.
    Each is zero-size when off."""
    n, u, e, p = wl.n_nodes, wl.state_width, cfg.pool_size, plan_slots
    if e < n + p:
        raise ValueError(
            f"pool_size={e} must hold one on_init event per node ({n}) "
            f"plus the {p} fault-plan rows"
        )
    _check_meta_ranges(wl)
    _check_obs(cov_words, cov_hitcount, timeline_cap, latency)
    rt_c = _check_retry(wl, retry)
    cw, tc = cov_words, timeline_cap
    tc_c = tc if causal else 0
    lat_c = latency.ops if latency is not None else 0
    lat_p = latency.phases if latency is not None else 0
    dev = resolve_device(device)
    base_state = host_to_device(torch.from_numpy(wl.initial_state()), dev)
    h = wl.history.capacity if wl.history is not None else 0
    d = n if wl.durable_sync else 0
    m = N_METRICS if metrics else 0

    def init(seeds, plan: PlanRows | None = None) -> SimState:
        seed = _seeds_tensor(seeds, dev)
        s = seed.shape[0]
        z = lambda *shape, dt: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
        ev_valid = z(s, e, dt=torch.bool)
        ev_valid[:, :n] = True
        kind = torch.full((s, e), KIND_NOP, dtype=torch.int32, device=dev)
        kind[:, :n] = FIRST_USER_KIND
        # slots past the on_init rows target node 0, as in the reference
        node1 = torch.ones((s, e), dtype=torch.int32, device=dev)
        node1[:, :n] = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
        ev_time = z(s, e, dt=torch.int64)
        ev_args = z(s, e, wl.args_words, dt=torch.int32)
        ev_epoch = z(s, e, dt=torch.int32)
        ev_parent = torch.full((s, e if causal else 0), PARENT_NONE, dtype=torch.int32,
                               device=dev)
        if p:
            if plan is None:
                raise ValueError(
                    f"init was built with plan_slots={p}; pass the compiled "
                    f"PlanRows"
                )
            pk = _plan_col(plan.kind, torch.int32, dev)
            if tuple(pk.shape) != (s, p):
                raise ValueError(
                    f"the plan carries rows of shape {tuple(pk.shape)}; "
                    f"{s} seeds and plan_slots={p} need {(s, p)}"
                )
            rows = slice(n, n + p)
            ev_valid[:, rows] = _plan_col(plan.valid, torch.bool, dev)
            kind[:, rows] = pk
            ev_time[:, rows] = _plan_col(plan.time, torch.int64, dev)
            ev_args[:, rows, 0:2] = _plan_col(plan.args, torch.int32, dev)
            is_user_row = (pk >= FIRST_USER_KIND) & (pk < FIRST_EXT_KIND)
            ev_epoch[:, rows] = torch.where(is_user_row, -1, 0).to(torch.int32)
            if causal:
                ev_parent[:, rows] = torch.where(is_user_row, PARENT_ARMY,
                                                 PARENT_PLAN).to(torch.int32)
            # clipped to the meta byte like every emit: an out-of-range
            # target matches nothing downstream
            pn = (
                torch.zeros_like(pk) if plan.node is None
                else _plan_col(plan.node, torch.int32, dev)
            )
            node1[:, rows] = pn.clamp(-1, n) + 1
        meta = _meta_pack(kind, node1, torch.zeros_like(kind), torch.zeros_like(kind))
        return SimState(
            seed=seed,
            now=z(s, dt=torch.int64),
            step=z(s, dt=torch.int64),
            halted=z(s, dt=torch.bool),
            halt_time=z(s, dt=torch.int64),
            trace=z(s, dt=torch.int64),
            overflow=z(s, dt=torch.int32),
            msg_count=z(s, dt=torch.int64),
            ev_time=ev_time,
            ev_valid=ev_valid,
            ev_meta=meta,
            ev_epoch=ev_epoch,
            ev_args=ev_args,
            ev_pay=z(s, e, wl.payload_words, dt=torch.int32),
            alive=torch.ones((s, n), dtype=torch.bool, device=dev),
            paused=z(s, n, dt=torch.bool),
            epoch=z(s, n, dt=torch.int32),
            node_state=base_state.expand(s, n, u).contiguous(),
            clog=z(s, n, n, dt=torch.bool),
            slow=torch.ones((s, n, n), dtype=torch.int32, device=dev),
            dup=z(s, dt=torch.bool),
            skew=z(s, n, dt=torch.int32),
            disk=base_state[:d].expand(s, d, u).contiguous(),
            wmask=z(s, d, u, dt=torch.bool),
            sync_loss=z(s, d, dt=torch.bool),
            sync_eio=z(s, d, dt=torch.bool),
            torn=z(s, d, dt=torch.bool),
            hist_count=z(s, dt=torch.int32),
            hist_drop=z(s, dt=torch.int32),
            hist_word=z(s, h, 5, dt=torch.int32),
            hist_t=z(s, h, dt=torch.int64),
            met=z(s, m, dt=torch.int32),
            cov=z(s, cw, dt=torch.int64),
            cov_last=z(s, n if cw else 0, dt=torch.int32),
            cov_hits=z(s, cw * 32 if cov_hitcount else 0, dt=torch.uint8),
            tl_count=z(s, dt=torch.int32),
            tl_drop=z(s, dt=torch.int32),
            tl_t=z(s, tc, dt=torch.int64),
            tl_meta=z(s, tc, dt=torch.int64),
            tl_args=z(s, tc, wl.args_words, dt=torch.int32),
            tl_pay=z(s, tc, wl.payload_words, dt=torch.int32),
            ev_emit=z(s, e if tc else 0, dt=torch.int64),
            tl_emit=z(s, tc, dt=torch.int64),
            lam=z(s, n if causal else 0, dt=torch.int64),
            ev_parent=ev_parent,
            ev_lam=z(s, e if causal else 0, dt=torch.int64),
            tl_seq=z(s, tc_c, dt=torch.int32),
            tl_parent=z(s, tc_c, dt=torch.int32),
            tl_lam=z(s, tc_c, dt=torch.int64),
            lat_inv=torch.full((s, lat_c), -1, dtype=torch.int64, device=dev),
            lat_resp=torch.full((s, lat_c), -1, dtype=torch.int64, device=dev),
            lat_hist=z(s, lat_p, N_LAT_BUCKETS if lat_c else 0, dt=torch.int32),
            lat_count=z(s, dt=torch.int32),
            lat_drop=z(s, dt=torch.int32),
            rt_done=z(s, rt_c, dt=torch.bool),
            rt_attempt=z(s, rt_c, dt=torch.int32),
            rt_deadline=z(s, rt_c, dt=torch.int64),
        )

    return init


# ---------------------------------------------------------------------------
# the plain eager step
# ---------------------------------------------------------------------------


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Row-wise index of the FIRST minimum (jnp.argmin's tie-break),
    pinned explicitly rather than left to the backend."""
    idx = torch.arange(x.shape[1], device=x.device)
    hit = x == x.min(dim=1, keepdim=True).values
    return torch.where(hit, idx, x.shape[1]).min(dim=1).values


def _with_records(out: tuple, rr: int, s: int, dev, ll: int = 0) -> tuple:
    """A handler's ``(state, Emits)`` with ``rr`` record rows, a sync
    flag and ``ll`` latency-marker rows: hand-built ``Emits`` (not
    through ``ctx.emits()``) record, sync and mark nothing."""
    state, em = out
    lv = em.lat_valid
    if lv is None or (ll > 0 and lv.shape[1] == 0):
        em = dataclasses.replace(
            em,
            lat_valid=torch.zeros((s, ll), dtype=torch.bool, device=dev),
            lat=torch.zeros((s, ll, 2), dtype=torch.int32, device=dev),
        )
    elif lv.shape[1] != ll:
        raise ValueError(
            f"handler returned Emits with {lv.shape[1]} latency-marker rows but "
            f"Workload.lat_markers={ll}; build emits via ctx.emits() (EmitBuilder) "
            f"to get the right row count"
        )
    if em.sync is None:
        em = dataclasses.replace(em, sync=torch.zeros((s,), dtype=torch.bool, device=dev))
    rv = em.rec_valid
    if rv is None or (rr > 0 and rv.shape[1] == 0):
        em = dataclasses.replace(
            em,
            rec_valid=torch.zeros((s, rr), dtype=torch.bool, device=dev),
            rec=torch.zeros((s, rr, 4), dtype=torch.int32, device=dev),
        )
    elif rv.shape[1] != rr:
        raise ValueError(
            f"handler returned Emits with {rv.shape[1]} history-record rows "
            f"but the workload's HistorySpec allows {rr}; build emits via "
            f"ctx.emits() (EmitBuilder) to get the right row count"
        )
    return state, em


def _cov_mix(x: torch.Tensor) -> torch.Tensor:
    """The reference's 32-bit feature finalizer on uint32 values held in
    int64: each product is masked to 32 bits before the next shift (the
    int64 product may wrap; its low 32 bits are the uint32 product)."""
    x = x & M32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & M32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & M32
    return x ^ (x >> 16)


# the hit-count class edges: 1, 2, 3, 4-7, 8-15, 16-31, 32-127, 128+
_COV_CLASS_EDGES = (1, 2, 3, 4, 8, 16, 32, 128)


def _cov_tapper(cov_words: int, cov_hitcount: bool, ar: torch.Tensor):
    """``tap(cov, cov_hits, feat, on) -> (cov, cov_hits)``: fold one
    (S,) feature word into each seed's bitmap where ``on``. With hit
    counts the feature's counter (a saturating byte per bit position)
    counts it first, and the bit set is that of the feature keyed by the
    counter's class; a later tap of the same step on the same position
    sees the increment."""
    mask = cov_words * 32 - 1

    def set_bit(cov, feat, on):
        bit = _cov_mix(feat) & mask
        word = bit >> 5
        m = torch.where(on, torch.ones_like(bit) << (bit & 31), 0)
        cov = cov.clone()
        cov[ar, word] = cov[ar, word] | m
        return cov

    if not cov_hitcount:
        return lambda cov, hits, feat, on: (set_bit(cov, feat, on), hits)

    def tap(cov, hits, feat, on):
        ci = _cov_mix(feat) & mask
        cur = hits[ar, ci].to(torch.int64)
        newc = torch.clamp(cur + 1, max=255)
        cls = sum((newc >= t).to(torch.int64) for t in _COV_CLASS_EDGES) - 1
        hits = hits.clone()
        hits[ar, ci] = torch.where(on, newc, cur).to(torch.uint8)
        feat2 = feat ^ (((cls + 1) * 0x9E3779B9) & M32)
        return set_bit(cov, feat2, on), hits

    return tap


def _plain_step_fn(wl: Workload, cfg: EngineConfig, dup_rows: bool = False,
                   metrics: bool = False, cov_words: int = 0, cov_hitcount: bool = False,
                   timeline_cap: int = 0, latency: "LatencySpec | None" = None,
                   causal: bool = False, retry: "RetrySpec | None" = None):
    """The eager batched step: ``step(SimState) -> SimState``.

    ``dup_rows`` adds the duplication shadow rows: K rows after the
    restart row, row j a copy of user emit row j when it is a send and
    the seed's ``dup`` flag is set, each with its own latency and loss
    pair at purpose ``PURPOSE_DUP + j``. Their lanes sit between the
    emit rows' and the user purposes', so the user lanes move up by K.
    Under the sync discipline the torn-write lane (``PURPOSE_TORN``)
    follows them, before the user purposes. ``metrics`` folds the fleet
    counters into ``SimState.met`` (a state from
    ``make_init(metrics=True)``). ``cov_words``, ``cov_hitcount`` and
    ``timeline_cap`` run the coverage taps and the timeline ring over a
    state from ``make_init`` with the same arguments; like ``metrics``
    they never feed back into the trajectory. So does ``latency``: the
    handlers' latency markers stamp the per-op clocks and fold completed
    ops into the sketch (a state from ``make_init(latency=...)``), and
    ``causal``: the Lamport fold, each placed row's parent seq and clock,
    the ring's causal columns and, with coverage, the (depth, jump)
    feature under tag 7 (a state from ``make_init(causal=True)``).

    ``retry=RetrySpec(...)`` runs the client-retry timers (a state from
    ``make_init(retry=...)``): an army row, a dispatch of the policy's
    kind at its node whose token names one of its ops, is suppressed
    once its op has its response or when it carries the give-up
    attempt, and otherwise delivered and arms one re-send timer row
    after every other emit row. A suppressed row dispatches with none of
    its handler's effects: it folds the trace, the clock, the causal
    columns and the ring, and counts in the retry books. Its jitter lane
    (``PURPOSE_RETRY``) follows the torn lane, before the user lanes."""
    n, k, w, aw = wl.n_nodes, wl.max_emits, wl.payload_words, wl.args_words
    n_user = len(wl.handlers)
    _check_meta_ranges(wl)
    _check_obs(cov_words, cov_hitcount, timeline_cap, latency)
    rt_c = _check_retry(wl, retry)
    if rt_c:
        rt_boff, rt_bjit = _retry_backoff_tables(retry)
    ll = wl.lat_markers
    lat_c = latency.ops if latency is not None else 0
    lat_p = latency.phases if latency is not None else 0
    lat_phase_ns = latency.phase_ns if latency is not None else 1
    lat_spec = latency  # the step's own `latency` is the emit rows' draw
    user_purposes = tuple(int(p) for p in (wl.draw_purposes or ()))
    n_em_lanes = (k + 1) + (k if dup_rows else 0)
    lane_p = [PURPOSE_POLL_COST]
    lane_p += [PURPOSE_LATENCY + s for s in range(k + 1)]
    if dup_rows:
        lane_p += [PURPOSE_DUP + s for s in range(k)]
    sync_on = wl.durable_sync
    i_torn = len(lane_p)
    if sync_on:
        lane_p.append(PURPOSE_TORN)
    # the re-send jitter: one lane a dispatch, keyed by the arming step
    i_retry = len(lane_p)
    if rt_c:
        lane_p.append(PURPOSE_RETRY)
    i_user = len(lane_p)
    lane_p += [PURPOSE_USER + p for p in user_purposes]
    # threefry blocks a step draws while its seed is active (MET_RNG):
    # the poll block and every lane above it
    rng_blocks = len(lane_p) - len(user_purposes)
    loss_u32 = cfg.loss_u32
    time_limit = cfg.time_limit
    lat_span = max(cfg.lat_max_ns - cfg.lat_min_ns, 1)
    proc_span = max(cfg.proc_max_ns - cfg.proc_min_ns, 1)
    init_rows_np = wl.initial_state()
    volatile_np = wl.volatile_mask()
    hcap = wl.history.capacity if wl.history is not None else 0
    rr = wl.history.max_records if wl.history is not None else 0
    checked: list = []  # non-empty once every handler has run

    def step(st: SimState) -> SimState:
        if metrics and st.met.shape[1] != N_METRICS:
            raise ValueError(
                f"a step built with metrics=True needs a state from "
                f"make_init(metrics=True); this one has {st.met.shape[1]} "
                f"metric slots"
            )
        check_obs_state(st, cov_words, cov_hitcount, timeline_cap)
        check_lat_state(st, lat_spec)
        check_causal_state(st, causal, n)
        check_retry_state(st, retry)
        dev = st.seed.device
        s_n, e_n = st.ev_valid.shape
        ar = torch.arange(s_n, device=dev)
        node_ids = torch.arange(n, dtype=torch.int32, device=dev)
        ir = torch.from_numpy(init_rows_np).to(dev)
        vo = torch.from_numpy(volatile_np).to(dev)

        # ---- pop the earliest pending event (first minimum) ----
        tmask = torch.where(st.ev_valid, st.ev_time, _INF_NS)
        i = _first_argmin(tmask)
        has_event = st.ev_valid[ar, i]
        ev_time_i = st.ev_time[ar, i]
        ev_t = torch.maximum(st.now, ev_time_i)
        over_limit = ev_t > time_limit
        active = has_event & ~st.halted & ~over_limit

        meta_i = st.ev_meta[ar, i]
        kind = _meta_kind(meta_i)
        dst = _meta_node(meta_i)
        src = _meta_src(meta_i)
        args = st.ev_args[ar, i]
        ev_epoch_i = st.ev_epoch[ar, i]
        pay_i = st.ev_pay[ar, i]
        # the emit-time sidecar: when this event entered the pool, read
        # before placement can reuse its slot
        emit_i = st.ev_emit[ar, i] if timeline_cap else None
        # the causal sidecars: the popped row's emitting dispatch seq and
        # the clock it folded, read by the same rule
        if causal:
            parent_i, evlam_i = st.ev_parent[ar, i], st.ev_lam[ar, i]
        is_engine = (kind < FIRST_USER_KIND) | (kind >= FIRST_EXT_KIND)
        is_msg = src >= 0

        # per-event reads; an out-of-range dst reads as a dead node with
        # a zero state row
        in_range = (dst >= 0) & (dst < n)
        dst_c = dst.clamp(0, n - 1).long()
        state_row = torch.where(in_range[:, None], st.node_state[ar, dst_c], 0)
        alive_dst = st.alive[ar, dst_c] & in_range
        paused_dst = st.paused[ar, dst_c] & in_range
        epoch_dst = torch.where(in_range, st.epoch[ar, dst_c], 0)
        skew_dst = torch.where(in_range, st.skew[ar, dst_c], 0)
        # the handling node's fsync-EIO flag before the dispatch
        eio_dst = (
            st.sync_eio[ar, dst_c] & in_range if sync_on
            else torch.zeros_like(in_range)
        )

        # liveness/epoch gate (epoch -1 = any incarnation)
        live = alive_dst & ((epoch_dst == ev_epoch_i) | (ev_epoch_i == -1))
        # clogged links hold messages (backoff reschedule); the sender
        # index clamps like the reference's gather
        src_c = src.clamp(0, n - 1).long()
        clogged = is_msg & st.clog[ar, src_c, dst_c] & in_range
        # a paused node's user events are held and retried
        held = ~is_engine & paused_dst
        blocked = clogged | held
        dispatch = active & ~blocked & (is_engine | live)

        # ---- the client-retry decode: an army row is a user dispatch of
        # the policy's kind at its node whose token names one of its ops;
        # it delivers unless its op has had its response (rt_done before
        # this dispatch) or it carries the give-up attempt ----
        if rt_c:
            rt_tok = args[:, 0]
            rt_idx = (rt_tok & RETRY_OP_MASK) - retry.op_base
            rt_att = (rt_tok >> RETRY_ATTEMPT_SHIFT) & RETRY_ATTEMPT_MAX
            rt_in_r = (rt_idx >= 0) & (rt_idx < rt_c)
            is_army = (dispatch & ~is_engine & (kind == retry.kind) & (dst == retry.node)
                       & rt_in_r)
            rt_ix = rt_idx.clamp(0, rt_c - 1).long()
            rt_done_i = st.rt_done[ar, rt_ix] & rt_in_r
            rt_deliver = ~rt_done_i & (rt_att < retry.max_attempts)
            rt_suppress = is_army & ~rt_deliver
            rt_arm = is_army & rt_deliver

        # ---- the causal fold: the dispatch's seq (int32, clamped below
        # 2^31), and the Lamport receive max(own, sender's) + 1 in uint32,
        # written only where the step dispatches to a node in range.
        # Derived state: read only into more causal columns ----
        if causal:
            seq = torch.clamp(st.step, max=ABSINT_STEP_MAX - 1).to(torch.int32)
            lam_prev = torch.where(in_range, st.lam[ar, dst_c], 0)
            lam_new = (torch.maximum(lam_prev, evlam_i) + 1) & M32
            lam = st.lam.clone()
            fold = dispatch & in_range
            lam[ar[fold], dst_c[fold]] = lam_new[fold]
        else:
            lam = st.lam

        now = torch.where(active, ev_t, st.now)
        draw = Draw(st.seed, st.step)
        # the per-dispatch block: lane 0 poll cost / clog jitter, lanes
        # 1..k+1 per-emit latency / loss, then the user lanes
        lane0, lane1 = draw.block2(lane_p)
        cost = cfg.proc_min_ns + lane0[:, 0] % proc_span
        clog_jit = lane1[:, 0] % 1000
        now_after = torch.where(dispatch, now + cost, now)

        # ---- consume / reschedule the popped slot ----
        retries = _meta_retry(meta_i)
        shift = torch.clamp(retries, max=34).to(torch.int64)
        backoff = torch.clamp(
            torch.full_like(shift, cfg.clog_backoff_min_ns) << shift,
            max=cfg.clog_backoff_max_ns,
        ) + clog_jit
        resched = active & blocked & (is_engine | live)
        meta_bumped = (meta_i & 0x00FFFFFF) | (
            torch.clamp(retries + 1, max=255).to(torch.int64) << 24
        )
        ev_valid = st.ev_valid.clone()
        ev_valid[ar, i] = resched
        ev_time = st.ev_time.clone()
        ev_time[ar, i] = torch.where(resched, now + backoff, ev_time_i)
        ev_meta = st.ev_meta.clone()
        ev_meta[ar, i] = torch.where(resched, meta_bumped, meta_i)

        # ---- dispatch: evaluate the handlers, select by kind; a
        # suppressed army row applies none of its handler's effects ----
        user_row_ok = ~is_engine & ~rt_suppress if rt_c else ~is_engine
        user_dispatch = dispatch & user_row_ok
        outs = []
        if n_user:
            user_idx = (kind - FIRST_USER_KIND).clamp(0, n_user - 1)
            # handler draws at the declared purposes read the block
            draw.cache = {
                PURPOSE_USER + p: (lane0[:, i_user + j], lane1[:, i_user + j])
                for j, p in enumerate(user_purposes)
            } or None
            ctx = HandlerCtx(
                now=now + skew_dst.to(torch.int64),
                node=dst,
                state=state_row,
                args=args,
                src=src,
                draw=draw,
                max_emits=k,
                payload=pay_i,
                payload_words=w,
                args_words=aw,
                max_records=rr,
                sync_err=eio_dst,
                lat_markers=ll,
            )
            # only the handlers some seed dispatches this step: a row's
            # handler output is read only where it user-dispatches, and
            # handlers are pure, so the values are those of evaluating
            # every one and selecting. The first step runs them all,
            # which checks each one's Emits shape.
            if checked:
                need = torch.unique(user_idx[user_dispatch]).tolist()
            else:
                need = list(range(n_user))
                checked.append(True)
            outs = [_with_records(wl.handlers[h](ctx), rr, s_n, dev, ll) for h in need]
            lut = torch.zeros((n_user,), dtype=torch.int64, device=dev)
            lut[need] = torch.arange(len(need), device=dev)
            pick = lut[user_idx.long()]

        def sel(vals):
            return vals[0] if len(vals) == 1 else torch.stack(vals, 0)[pick, ar]

        if outs:
            user_state = sel([torch.as_tensor(o[0]).to(torch.int32) for o in outs])
            uem = Emits(*(
                sel([getattr(o[1], f.name) for o in outs])
                for f in dataclasses.fields(Emits)
            ))
        else:
            user_state = state_row
            uem = EmitBuilder(k, w, aw, s_n, dev, rr, ll).build()

        row = torch.where(user_dispatch[:, None], user_state, state_row)
        node_state = st.node_state.clone()
        node_state[ar[in_range], dst_c[in_range]] = row[in_range]

        # ---- engine effects: kill / restart / pause / clog / halt ----
        a0, a1 = args[:, 0], args[:, 1]
        kill_id = torch.where(dispatch & (kind == KIND_KILL), a0, -1)
        restart_id = torch.where(dispatch & (kind == KIND_RESTART), a0, -1)
        is_killed = node_ids[None, :] == kill_id[:, None]
        is_restarted = node_ids[None, :] == restart_id[:, None]
        alive = (st.alive & ~is_killed) | is_restarted
        is_pause_kind = (kind == KIND_PAUSE) | (kind == KIND_RESUME)
        pause_id = torch.where(dispatch & is_pause_kind, a0, -1)
        paused = torch.where(
            node_ids[None, :] == pause_id[:, None],
            (kind == KIND_PAUSE)[:, None],
            st.paused,
        )
        paused = paused & ~(is_killed | is_restarted)
        epoch = st.epoch + is_killed.to(torch.int32) + is_restarted.to(torch.int32)
        node_state = torch.where(
            is_restarted[:, :, None] & vo[None, None, :], ir[None], node_state
        )

        is_clog_kind = (kind >= KIND_CLOG) & (kind <= KIND_UNCLOG_NODE)
        clog_on = (kind == KIND_CLOG) | (kind == KIND_CLOG_NODE)
        clog_set = torch.where(dispatch & is_clog_kind, clog_on.to(torch.int32), -1)
        is_node_clog = (kind == KIND_CLOG_NODE) | (kind == KIND_UNCLOG_NODE)
        ca = a0[:, None, None]
        cb = torch.where(is_node_clog, -1, a1)[:, None, None]
        src_ax = node_ids[None, :, None]
        dst_ax = node_ids[None, None, :]
        # clog_link(a, b) blocks both directions; clog_node(a) (b < 0)
        # blocks everything in or out of a
        sel_c = ((src_ax == ca) & (dst_ax == cb)) | ((src_ax == cb) & (dst_ax == ca))
        sel_c = sel_c | ((cb < 0) & ((src_ax == ca) | (dst_ax == ca)))
        cs = clog_set[:, None, None]
        clog = torch.where(
            sel_c & (cs == 1), True, torch.where(sel_c & (cs == 0), False, st.clog)
        )
        # the asymmetric partition edge: one direction only
        is_c1w = (kind == KIND_CLOG_1W) | (kind == KIND_UNCLOG_1W)
        c1w_set = torch.where(
            dispatch & is_c1w, (kind == KIND_CLOG_1W).to(torch.int32), -1
        )[:, None, None]
        sel_1w = (src_ax == ca) & (dst_ax == a1[:, None, None])
        clog = torch.where(
            sel_1w & (c1w_set == 1), True,
            torch.where(sel_1w & (c1w_set == 0), False, clog),
        )

        # ---- extended chaos: gray failure, duplication, skew. The
        # identities (slow 1, dup off, skew 0) change nothing for a
        # workload that never emits them. A slow kind OVERWRITES every
        # cell it selects, pair or node-wide; UNSLOW writes 1 ----
        is_slow_kind = (kind == KIND_SLOW_LINK) | (kind == KIND_UNSLOW)
        slow_b = ((a1 & 0xFF) - 1)[:, None, None]  # packed peer; -1 node-wide
        slow_mult = torch.clamp(a1 >> 8, min=1)  # arithmetic shift
        slow_mult = torch.where(kind == KIND_UNSLOW, 1, slow_mult)
        slow_set = torch.where(dispatch & is_slow_kind, slow_mult, -1)[:, None, None]
        pair_sl = ((src_ax == ca) & (dst_ax == slow_b)) | ((src_ax == slow_b) & (dst_ax == ca))
        node_sl = (slow_b < 0) & ((src_ax == ca) | (dst_ax == ca))
        slow = torch.where((pair_sl | node_sl) & (slow_set > 0), slow_set, st.slow).to(torch.int32)
        is_dup_kind = (kind == KIND_DUP_ON) | (kind == KIND_DUP_OFF)
        dup = torch.where(dispatch & is_dup_kind, kind == KIND_DUP_ON, st.dup)
        skew_id = torch.where(dispatch & (kind == KIND_SKEW), a0, -1)
        skew = torch.where(node_ids[None, :] == skew_id[:, None], a1[:, None], st.skew)

        # ---- the two-phase sync discipline: durable writes buffer until
        # a sync commits them to the node's disk image; a kill reverts
        # the durable columns to that image, or under an armed torn mode
        # keeps a drawn prefix (column order) of the last uncommitted
        # write on top of it ----
        if sync_on:
            dur_m = ~vo  # (U,) the durable columns
            dst_oh = (node_ids[None, :] == dst[:, None])  # all False out of range
            # the chaos windows: args[0] = node, -1 = every node
            sel_n = (node_ids[None, :] == a0[:, None]) | (a0 < 0)[:, None]
            is_sl = dispatch & (kind == KIND_SYNC_LOSS)
            eio_mode = a1 == 1
            sl_off = (dispatch & (kind == KIND_SYNC_OK))[:, None] & sel_n
            sync_loss = torch.where((is_sl & ~eio_mode)[:, None] & sel_n, True,
                                    torch.where(sl_off, False, st.sync_loss))
            sync_eio = torch.where((is_sl & eio_mode)[:, None] & sel_n, True,
                                   torch.where(sl_off, False, st.sync_eio))
            tn_on = (dispatch & (kind == KIND_TORN_ON))[:, None] & sel_n
            tn_off = (dispatch & (kind == KIND_TORN_OFF))[:, None] & sel_n
            torn = torch.where(tn_on, True, torch.where(tn_off, False, st.torn))
            # this dispatch's changed durable columns replace the node's
            # mask: only the newest unsynced write tears
            changed = (row != state_row) & dur_m[None, :]
            wrote = user_dispatch & changed.any(1)
            wmask = torch.where((dst_oh & wrote[:, None])[:, :, None], changed[:, None, :],
                                st.wmask)
            # the commit, unless the disk lies or fails (no commit, no
            # mask clear either way)
            lying = (sync_loss | sync_eio)[ar, dst_c] & in_range
            do_sync = user_dispatch & uem.sync & ~lying
            sync_lied = user_dispatch & uem.sync & lying
            synced = (dst_oh & do_sync[:, None])[:, :, None]
            disk = torch.where(synced & dur_m[None, None, :], node_state, st.disk)
            wmask = wmask & ~synced
            # the crash: keep_cnt is the uint32 torn word mod (dirty + 1)
            torn_bits = lane0[:, i_torn]
            n_dirty = wmask.sum(2)
            rank = wmask.to(torch.int64).cumsum(2) - 1
            keep_cnt = torn_bits[:, None] % (n_dirty + 1)
            torn_keep = wmask & torn[:, :, None] & (rank < keep_cnt[:, :, None])
            crash_val = torch.where(torn_keep, node_state, disk)
            crash_sel = is_killed[:, :, None] & dur_m[None, None, :]
            tore = (is_killed & torn).any(1)
            node_state = torch.where(crash_sel, crash_val, node_state)
            disk = torch.where(crash_sel, crash_val, disk)
            wmask = wmask & ~is_killed[:, :, None]
        else:
            disk, wmask = st.disk, st.wmask
            sync_loss, sync_eio, torn = st.sync_loss, st.sync_eio, st.torn

        halted = st.halted | (dispatch & (kind == KIND_HALT)) | (has_event & over_limit)
        halt_time = torch.where(
            halted & ~st.halted, torch.clamp(now, max=time_limit), st.halt_time
        )

        # ---- emits: the user rows plus the restart row (the reborn
        # node's on_init timer) ----
        restart_row = kind == KIND_RESTART
        ev_valid_em = torch.cat(
            [uem.valid & user_row_ok[:, None], restart_row[:, None]], 1
        )
        em_send = torch.cat([uem.send, torch.zeros_like(restart_row)[:, None]], 1)
        em_kind = torch.cat(
            [uem.kind, torch.full_like(kind, FIRST_USER_KIND)[:, None]], 1
        )
        em_dst = torch.cat([uem.dst, a0[:, None]], 1)
        em_delay = torch.cat([uem.delay, torch.zeros_like(now)[:, None]], 1)
        em_args = torch.cat([uem.args, torch.zeros_like(args)[:, None]], 1)
        em_pay = torch.cat([uem.pay, torch.zeros_like(pay_i)[:, None]], 1)
        if dup_rows:
            # the shadow rows: each user send again while dup is on
            dvalid = uem.valid & user_row_ok[:, None] & uem.send & st.dup[:, None]
            ev_valid_em = torch.cat([ev_valid_em, dvalid], 1)
            em_send = torch.cat([em_send, uem.send], 1)
            em_kind = torch.cat([em_kind, uem.kind], 1)
            em_dst = torch.cat([em_dst, uem.dst], 1)
            em_delay = torch.cat([em_delay, uem.delay], 1)
            em_args = torch.cat([em_args, uem.args], 1)
            em_pay = torch.cat([em_pay, uem.pay], 1)

        lat_bits = lane0[:, 1 : 1 + n_em_lanes]
        loss_bits = lane1[:, 1 : 1 + n_em_lanes]
        if rt_c:
            # the armed re-send, last: a timer of the policy's kind to its
            # node carrying the next attempt's token, at timeout + backoff
            # + jitter (int64: the jitter table's cap keeps the product
            # under 2^63). A timer reads no latency or loss lane
            rt_next = rt_att + 1
            rt_boff_t = torch.zeros_like(now)
            rt_bjit_t = torch.zeros_like(now)
            for a in range(1, retry.max_attempts + 1):
                rt_boff_t = torch.where(rt_next == a, rt_boff[a], rt_boff_t)
                rt_bjit_t = torch.where(rt_next == a, rt_bjit[a], rt_bjit_t)
            rt_jit = (rt_bjit_t * lane0[:, i_retry].to(torch.int64)) >> 32
            rt_delay = retry.timeout_ns + rt_boff_t + rt_jit
            rt_args = args.clone()
            rt_args[:, 0] = (rt_tok & RETRY_OP_MASK) | (rt_next << RETRY_ATTEMPT_SHIFT)
            ev_valid_em = torch.cat([ev_valid_em, rt_arm[:, None]], 1)
            em_send = torch.cat([em_send, torch.zeros_like(rt_arm)[:, None]], 1)
            em_kind = torch.cat([em_kind, torch.full_like(kind, retry.kind)[:, None]], 1)
            em_dst = torch.cat([em_dst, torch.full_like(dst, retry.node)[:, None]], 1)
            em_delay = torch.cat([em_delay, rt_delay[:, None]], 1)
            em_args = torch.cat([em_args, rt_args[:, None]], 1)
            em_pay = torch.cat([em_pay, torch.zeros_like(pay_i)[:, None]], 1)
            zl = torch.zeros_like(lat_bits[:, :1])
            lat_bits = torch.cat([lat_bits, zl], 1)
            loss_bits = torch.cat([loss_bits, zl], 1)
        latency = cfg.lat_min_ns + lat_bits % lat_span
        lost = em_send & (loss_bits < loss_u32)
        e_valid = dispatch[:, None] & ev_valid_em & ~lost
        # sends to dead nodes drop at send time; timers to dead nodes
        # die at the epoch gate
        em_in_range = (em_dst >= 0) & (em_dst < n)
        em_dst_c = em_dst.clamp(0, n - 1).long()
        alive_at_dst = alive[ar[:, None], em_dst_c] & em_in_range
        e_epoch = torch.where(em_in_range, epoch[ar[:, None], em_dst_c], 0)
        e_valid = e_valid & torch.where(em_send, alive_at_dst, True)
        # gray-failure latency multiplier of the sending node's row,
        # after this step's effects (like the alive gate)
        emit_mult = torch.where(
            in_range[:, None] & em_in_range,
            slow[ar[:, None], dst_c[:, None], em_dst_c],
            1,
        ).clamp(min=1)
        latency = torch.where(emit_mult > 1, latency * emit_mult, latency)
        e_time = now_after[:, None] + torch.where(em_send, latency, em_delay)
        e_src = torch.where(em_send, dst[:, None], -1)
        em_engine = (em_kind < FIRST_USER_KIND) | (em_kind >= FIRST_EXT_KIND)
        e_epoch = torch.where(em_engine, 0, e_epoch).to(torch.int32)
        e_meta = _meta_pack(
            torch.where(em_kind < 0, KIND_NOP, em_kind.clamp(max=255)),
            em_dst.clamp(-1, n) + 1,
            e_src.clamp(-1, n) + 1,
            torch.zeros_like(em_kind),
        )
        msg_count = st.msg_count + (
            dispatch[:, None] & ev_valid_em & em_send
        ).sum(1)

        # ---- compact placement: the j-th valid emit takes the j-th
        # free slot in pool order; a full pool drops and counts ----
        pos = torch.cumsum(e_valid.to(torch.int64), 1) - 1
        free = ~ev_valid
        n_free = free.sum(1, keepdim=True)
        dropped = e_valid & (pos >= n_free)
        overflow = st.overflow + dropped.sum(1).to(torch.int32)
        placed = e_valid & ~dropped
        # free slots first, in slot order (stable sort of the 0/1 key)
        free_order = torch.sort(
            (~free).to(torch.int8), dim=1, stable=True
        ).indices
        slot = free_order.gather(1, pos.clamp(0, e_n - 1))
        ps, pj = placed.nonzero(as_tuple=True)
        pslot = slot[ps, pj]
        ev_valid[ps, pslot] = True
        ev_time[ps, pslot] = e_time[ps, pj]
        ev_meta[ps, pslot] = e_meta[ps, pj]
        ev_epoch = st.ev_epoch.clone()
        ev_epoch[ps, pslot] = e_epoch[ps, pj]
        ev_args = st.ev_args.clone()
        ev_args[ps, pslot] = em_args[ps, pj]
        ev_pay = st.ev_pay.clone()
        ev_pay[ps, pslot] = em_pay[ps, pj]
        if timeline_cap:
            # every placed row was emitted at this dispatch's clock; a
            # rescheduled (clog-held) row keeps its emit time
            ev_emit = st.ev_emit.clone()
            ev_emit[ps, pslot] = now[ps]
        else:
            ev_emit = st.ev_emit
        if causal:
            # every placed row's parent is this dispatch, ring or no ring;
            # a rescheduled row keeps its parent (a retry is no new send)
            ev_parent, ev_lam = st.ev_parent.clone(), st.ev_lam.clone()
            ev_parent[ps, pslot] = seq[ps]
            ev_lam[ps, pslot] = lam_new[ps]
        else:
            ev_parent, ev_lam = st.ev_parent, st.ev_lam

        # ---- operation-history append: the j-th valid record of a user
        # dispatch takes slot hist_count + j; records past the capacity
        # are dropped and counted, so the kept ones are a prefix. The
        # row is [op, key, arg, client = the handling node, ok] and the
        # time is the dispatch clock without the node's skew. Records
        # draw nothing and fold nothing into the trace. ----
        if hcap > 0:
            r_valid = user_dispatch[:, None] & uem.rec_valid
            rpos = st.hist_count[:, None] + torch.cumsum(r_valid.to(torch.int32), 1) - 1
            fits = rpos < hcap
            keep = r_valid & fits
            rec_row = torch.cat(
                [uem.rec[:, :, :3], dst[:, None, None].expand(s_n, rr, 1),
                 uem.rec[:, :, 3:4]], 2,
            ).to(torch.int32)
            ks, kj = keep.nonzero(as_tuple=True)
            kslot = rpos[ks, kj].long()
            hist_word = st.hist_word.clone()
            hist_word[ks, kslot] = rec_row[ks, kj]
            hist_t = st.hist_t.clone()
            hist_t[ks, kslot] = now[ks]
            hist_count = st.hist_count + keep.sum(1).to(torch.int32)
            hist_drop = st.hist_drop + (r_valid & ~fits).sum(1).to(torch.int32)
        else:
            hist_count, hist_drop = st.hist_count, st.hist_drop
            hist_word, hist_t = st.hist_word, st.hist_t

        # ---- the tail-latency tap: a user dispatch's markers, in order
        # j = 0..L-1, each seeing the last one's writes. The first start
        # and the first response win; an end without a start is ignored;
        # an out-of-range op id counts only in lat_drop. A completed op
        # adds one to its (window of the invoke, ladder bucket of the
        # latency) cell. Nothing here feeds back into the trajectory ----
        lat_feats = []  # (feature, on) pairs for the coverage fold
        lat_inv, lat_resp, lat_hist = st.lat_inv, st.lat_resp, st.lat_hist
        lat_count, lat_drop = st.lat_count, st.lat_drop
        if lat_c and ll:
            lat_inv, lat_resp, lat_hist = lat_inv.clone(), lat_resp.clone(), lat_hist.clone()
            edges = torch.from_numpy(LAT_EDGES_NS).to(dev)
            for j in range(ll):
                mv = user_dispatch & uem.lat_valid[:, j]
                oid = uem.lat[:, j, 0]
                is_end = uem.lat[:, j, 1] == 1
                in_r = (oid >= 0) & (oid < lat_c)
                lat_drop = lat_drop + (mv & ~in_r).to(torch.int32)
                act = mv & in_r
                oc = oid.clamp(0, lat_c - 1).long()
                inv_o = torch.where(in_r, lat_inv[ar, oc], -1)
                resp_o = torch.where(in_r, lat_resp[ar, oc], -1)
                do_start = act & ~is_end & (inv_o < 0)
                do_end = act & is_end & (inv_o >= 0) & (resp_o < 0)
                bkt = ((now - inv_o)[:, None] >= edges[None, :]).sum(1)
                ph = torch.div(inv_o, lat_phase_ns, rounding_mode="floor")
                ph = ph.to(torch.int32).clamp(0, lat_p - 1).to(torch.int64)
                lat_inv[ar[do_start], oc[do_start]] = now[do_start]
                lat_resp[ar[do_end], oc[do_end]] = now[do_end]
                lat_hist[ar[do_end], ph[do_end], bkt[do_end]] += 1
                lat_count = lat_count + do_end.to(torch.int32)
                # the (window, bucket) coverage feature under tag 5
                lat_feats.append((bkt | (ph << 8) | (5 << 24), do_end))

        # ---- the client-retry books: each op whose lat_end marker (phase
        # 1) this user dispatch emits has its response; an armed op
        # records its delivered attempt and its deadline, from the clock
        # after the dispatch ----
        if rt_c:
            rt_done = st.rt_done.clone()
            rt_ids = torch.arange(rt_c, device=dev)
            for j in range(ll):
                mv = user_dispatch & uem.lat_valid[:, j] & (uem.lat[:, j, 1] == 1)
                hit = rt_ids[None, :] == (uem.lat[:, j, 0] - retry.op_base)[:, None]
                rt_done = rt_done | (hit & mv[:, None])
            rt_oh = (rt_ids[None, :] == rt_idx[:, None]) & rt_arm[:, None]
            rt_attempt = torch.where(rt_oh, rt_att[:, None], st.rt_attempt)
            rt_deadline = torch.where(rt_oh, (now_after + rt_delay)[:, None], st.rt_deadline)
        else:
            rt_done, rt_attempt, rt_deadline = st.rt_done, st.rt_attempt, st.rt_deadline

        # ---- the coverage taps: features of the dispatched event hashed
        # into the bitmap, in the reference's order. Nothing here feeds
        # back into the trajectory, the draws or the trace ----
        if cov_words:
            tap = _cov_tapper(cov_words, cov_hitcount, ar)
            cov, cov_hits = st.cov, st.cov_hits
            kind_w = kind.to(torch.int64)
            dst_w = dst.clamp(min=0).to(torch.int64)
            # the per-node kind transition (previous user kind -> kind)
            prev_kind = torch.where(in_range, st.cov_last[ar, dst_c], 0).to(torch.int64)
            f_user = kind_w | ((prev_kind & M32) << 8) | (dst_w << 16)
            cov, cov_hits = tap(cov, cov_hits, f_user, user_dispatch)
            # the coarse time phase (2^27 ns, about 134 ms, up to 31)
            phase = torch.clamp(now >> 27, max=31)
            f_chaos = kind_w | (phase << 8) | (1 << 24)
            cov, cov_hits = tap(cov, cov_hits, f_chaos, dispatch & is_engine)
            f_edge = kind_w | (src.clamp(min=0).to(torch.int64) << 8) | (dst_w << 16) | (3 << 24)
            cov, cov_hits = tap(cov, cov_hits, f_edge, user_dispatch & is_msg)
            f_when = kind_w | (phase << 8) | (4 << 24)
            cov, cov_hits = tap(cov, cov_hits, f_when, user_dispatch)
            if causal:
                # causal depth and jump (tag 7): the log2 buckets of the
                # folded clock and of how far the arriving event's clock
                # was ahead of the node's (int64, clipped at 0), on every
                # dispatch
                pow2 = torch.tensor([1 << b for b in range(1, 32)], device=dev)
                depth_b = (lam_new[:, None] >= pow2).sum(1)
                jump = torch.clamp(evlam_i - lam_prev, min=0)
                jump_b = (jump[:, None] >= pow2).sum(1)
                cov, cov_hits = tap(cov, cov_hits, depth_b | (jump_b << 8) | (7 << 24),
                                    dispatch)
            for j in range(rr):
                r = uem.rec[:, j].to(torch.int64) & M32
                f_rec = (
                    ((r[:, 0] * 0x9E3779B1) & M32) ^ ((r[:, 1] * 0x85EBCA6B) & M32)
                    ^ ((r[:, 2] * 0xC2B2AE35) & M32) ^ r[:, 3] ^ (2 << 24)
                )
                cov, cov_hits = tap(cov, cov_hits, f_rec, user_dispatch & uem.rec_valid[:, j])
            # completed client ops: the latency block's features
            for f_lat, on_lat in lat_feats:
                cov, cov_hits = tap(cov, cov_hits, f_lat, on_lat)
            if wl.cov_features is not None:
                # the workload's features of the post-dispatch fleet
                # state, their low 24 bits under tag 6
                for f_wl, on_wl in wl.cov_features(node_state, now):
                    f_wl = (torch.as_tensor(f_wl, device=dev).to(torch.int64) & 0xFFFFFF) | (6 << 24)
                    cov, cov_hits = tap(cov, cov_hits, f_wl.expand(s_n),
                                        user_dispatch & torch.as_tensor(on_wl, device=dev))
            cov_last = torch.where(
                (node_ids[None, :] == dst[:, None]) & user_dispatch[:, None],
                kind[:, None], st.cov_last,
            )
        else:
            cov, cov_last, cov_hits = st.cov, st.cov_last, st.cov_hits

        # ---- the fleet counters: values the step computed anyway, and
        # nothing here feeds back into the trajectory ----
        if metrics:
            sent_m = dispatch[:, None] & ev_valid_em & em_send
            inc = [torch.zeros_like(st.overflow)] * N_METRICS

            def n_of(b):
                return b.sum(1).to(torch.int32) if b.dim() == 2 else b.to(torch.int32)

            inc[MET_SENT] = n_of(sent_m)
            inc[MET_DELIVERED] = n_of(dispatch & is_msg)
            inc[MET_LOST] = n_of(sent_m & lost)
            inc[MET_DEAD_DROP] = n_of(sent_m & ~lost & ~alive_at_dst)
            if dup_rows:
                inc[MET_DUP] = n_of(e_valid[:, k + 1 : 2 * k + 1])
            inc[MET_CRASH] = n_of(dispatch & (kind == KIND_KILL))
            inc[MET_RESTART] = n_of(dispatch & (kind == KIND_RESTART))
            inc[MET_PAUSE] = n_of(dispatch & (kind == KIND_PAUSE))
            inc[MET_CLOG_BLOCK] = n_of(active & clogged)
            inc[MET_TIMER] = n_of(user_dispatch & ~is_msg)
            if hcap > 0:
                inc[MET_RECORD] = n_of(keep)
            inc[MET_RNG] = torch.where(active, rng_blocks, 0).to(torch.int32)
            if sync_on:
                inc[MET_SYNC] = n_of(do_sync)
                inc[MET_SYNC_LOST] = n_of(sync_lied)
                inc[MET_TORN] = n_of(tore)
            if rt_c:
                # a re-delivery is a delivered army row past attempt 0; a
                # give-up the sentinel popping with its op unanswered (a
                # sentinel that dies with a killed client is dropped by
                # the epoch gate first, an undercount the reference keeps)
                inc[MET_RETRY] = n_of(rt_arm & (rt_att > 0))
                inc[MET_RETRY_GIVEUP] = n_of(
                    is_army & ~rt_done_i & (rt_att == retry.max_attempts))
            met = st.met + torch.stack(inc, 1)
            # how the seed stopped: its halt, else the first step that
            # finds its pool empty
            code = torch.where(dispatch & (kind == KIND_HALT), HALT_DONE, HALT_TIME_LIMIT)
            cur = met[:, MET_HALT_CODE]
            idle = ~has_event & ~st.halted & (cur == HALT_RUNNING)
            met[:, MET_HALT_CODE] = torch.where(
                halted & ~st.halted, code, torch.where(idle, HALT_IDLE, cur))
        else:
            met = st.met

        # ---- the timeline ring: the dispatched row, the tuple the trace
        # folds, at slot tl_count; a full ring counts the drop ----
        if timeline_cap:
            tfits = st.tl_count < timeline_cap
            t_do = dispatch & tfits
            ts = ar[t_do]
            tslot = st.tl_count[t_do].long()
            tl_t, tl_meta, tl_args, tl_pay, tl_emit = (
                x.clone() for x in (st.tl_t, st.tl_meta, st.tl_args, st.tl_pay, st.tl_emit))
            tl_t[ts, tslot] = now[t_do]
            tl_meta[ts, tslot] = meta_i[t_do]
            tl_args[ts, tslot] = args[t_do]
            tl_pay[ts, tslot] = pay_i[t_do]
            tl_emit[ts, tslot] = emit_i[t_do]
            if causal:
                tl_seq, tl_parent, tl_lam = (
                    x.clone() for x in (st.tl_seq, st.tl_parent, st.tl_lam))
                tl_seq[ts, tslot] = seq[t_do]
                tl_parent[ts, tslot] = parent_i[t_do]
                tl_lam[ts, tslot] = lam_new[t_do]
            tl_count = st.tl_count + t_do.to(torch.int32)
            tl_drop = st.tl_drop + (dispatch & ~tfits).to(torch.int32)
        else:
            tl_count, tl_drop = st.tl_count, st.tl_drop
            tl_t, tl_meta, tl_args = st.tl_t, st.tl_meta, st.tl_args
            tl_pay, tl_emit = st.tl_pay, st.tl_emit
        if not (timeline_cap and causal):
            tl_seq, tl_parent, tl_lam = st.tl_seq, st.tl_parent, st.tl_lam

        # ---- trace + clock ----
        trace = torch.where(
            dispatch, _trace_fold(st.trace, now, kind, dst, args, pay_i), st.trace
        )
        return SimState(
            seed=st.seed,
            now=now_after,
            step=(st.step + 1) & M32,
            halted=halted,
            halt_time=halt_time,
            trace=trace,
            overflow=overflow,
            msg_count=msg_count,
            ev_time=ev_time,
            ev_valid=ev_valid,
            ev_meta=ev_meta,
            ev_epoch=ev_epoch,
            ev_args=ev_args,
            ev_pay=ev_pay,
            alive=alive,
            paused=paused,
            epoch=epoch,
            node_state=node_state,
            clog=clog,
            slow=slow,
            dup=dup,
            skew=skew,
            disk=disk,
            wmask=wmask,
            sync_loss=sync_loss,
            sync_eio=sync_eio,
            torn=torn,
            hist_count=hist_count,
            hist_drop=hist_drop,
            hist_word=hist_word,
            hist_t=hist_t,
            met=met,
            cov=cov,
            cov_last=cov_last,
            cov_hits=cov_hits,
            tl_count=tl_count,
            tl_drop=tl_drop,
            tl_t=tl_t,
            tl_meta=tl_meta,
            tl_args=tl_args,
            tl_pay=tl_pay,
            ev_emit=ev_emit,
            tl_emit=tl_emit,
            lam=lam,
            ev_parent=ev_parent,
            ev_lam=ev_lam,
            tl_seq=tl_seq,
            tl_parent=tl_parent,
            tl_lam=tl_lam,
            lat_inv=lat_inv,
            lat_resp=lat_resp,
            lat_hist=lat_hist,
            lat_count=lat_count,
            lat_drop=lat_drop,
            rt_done=rt_done,
            rt_attempt=rt_attempt,
            rt_deadline=rt_deadline,
        )

    return step


# ---------------------------------------------------------------------------
# entry points: the plain versions, and the dispatching ones that launch
# the fused kernel on a CUDA state
# ---------------------------------------------------------------------------


def make_step_plain(wl: Workload, cfg: EngineConfig, dup_rows: bool = False,
                    metrics: bool = False, cov_words: int = 0, timeline_cap: int = 0,
                    cov_hitcount: bool = False, latency: "LatencySpec | None" = None,
                    causal: bool = False, retry: "RetrySpec | None" = None):
    """The plain eager step on any device."""
    return _plain_step_fn(wl, cfg, dup_rows, metrics, cov_words, cov_hitcount, timeline_cap,
                          latency, causal, retry)


def make_run_plain(wl: Workload, cfg: EngineConfig, n_steps: int,
                   dup_rows: bool = False, metrics: bool = False, cov_words: int = 0,
                   timeline_cap: int = 0, cov_hitcount: bool = False,
                   latency: "LatencySpec | None" = None, causal: bool = False,
                   retry: "RetrySpec | None" = None):
    """``n_steps`` of the plain eager step on any device."""
    step = _plain_step_fn(wl, cfg, dup_rows, metrics, cov_words, cov_hitcount, timeline_cap,
                          latency, causal, retry)

    def run(state: SimState) -> SimState:
        for _ in range(n_steps):
            state = step(state)
        return state

    return run


def make_run_while_plain(wl: Workload, cfg: EngineConfig, max_steps: int,
                         dup_rows: bool = False, metrics: bool = False,
                         cov_words: int = 0, timeline_cap: int = 0,
                         cov_hitcount: bool = False, latency: "LatencySpec | None" = None,
                         causal: bool = False, retry: "RetrySpec | None" = None):
    """The plain eager step until every seed has halted, at most
    ``max_steps`` times; every seed takes the same number of steps."""
    step = _plain_step_fn(wl, cfg, dup_rows, metrics, cov_words, cov_hitcount, timeline_cap,
                          latency, causal, retry)

    def run(state: SimState) -> SimState:
        i = 0
        while i < max_steps and not bool(state.halted.all()):
            state = step(state)
            i += 1
        return state

    return run


def make_step(wl: Workload, cfg: EngineConfig, dup_rows: bool = False,
              metrics: bool = False, cov_words: int = 0, timeline_cap: int = 0,
              cov_hitcount: bool = False, latency: "LatencySpec | None" = None,
              causal: bool = False, retry: "RetrySpec | None" = None):
    """One step: the plain step on a CPU state, the fused kernel with
    ``n_steps=1`` on a CUDA state (raises for a workload whose family has
    no model trait in csrc/)."""
    from .fused import make_run_fused

    return make_run_fused(wl, cfg, 1, dup_rows=dup_rows, metrics=metrics,
                          cov_words=cov_words, timeline_cap=timeline_cap,
                          cov_hitcount=cov_hitcount, latency=latency, causal=causal,
                          retry=retry)


def make_run(wl: Workload, cfg: EngineConfig, n_steps: int, dup_rows: bool = False,
             metrics: bool = False, cov_words: int = 0, timeline_cap: int = 0,
             cov_hitcount: bool = False, latency: "LatencySpec | None" = None,
             causal: bool = False, retry: "RetrySpec | None" = None):
    """``n_steps`` steps: plain on a CPU state, the fused kernel on a
    CUDA state."""
    from .fused import make_run_fused

    return make_run_fused(wl, cfg, n_steps, dup_rows=dup_rows, metrics=metrics,
                          cov_words=cov_words, timeline_cap=timeline_cap,
                          cov_hitcount=cov_hitcount, latency=latency, causal=causal,
                          retry=retry)


def make_run_while(wl: Workload, cfg: EngineConfig, max_steps: int,
                   dup_rows: bool = False, metrics: bool = False, cov_words: int = 0,
                   timeline_cap: int = 0, cov_hitcount: bool = False,
                   latency: "LatencySpec | None" = None, causal: bool = False,
                   retry: "RetrySpec | None" = None):
    """Steps until every seed has halted, at most ``max_steps``: plain
    on a CPU state, the fused kernel on a CUDA state. ``metrics`` folds
    the fleet counters (a state from ``make_init(metrics=True)``);
    ``cov_words``, ``cov_hitcount`` and ``timeline_cap`` run the
    coverage taps and the timeline ring, ``latency`` the tail-latency
    tap, ``causal`` the causal fold and ``retry`` the client-retry
    timers (a state from ``make_init`` with the same arguments)."""
    from .fused import make_run_fused

    return make_run_fused(wl, cfg, max_steps, until_halted=True, dup_rows=dup_rows,
                          metrics=metrics, cov_words=cov_words, timeline_cap=timeline_cap,
                          cov_hitcount=cov_hitcount, latency=latency, causal=causal,
                          retry=retry)
