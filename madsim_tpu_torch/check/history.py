"""Host-side model of recorded operation histories.

A copy of the JAX package's ``madsim_tpu/check/history.py`` (numpy only):
the torch port imports nothing of that package, whose ``check``
loads JAX through its device screens.

The engine records histories as fixed-size on-device columns (the trace
discipline, engine/core.py): per seed, ``hist_count`` rows of
``hist_word`` = (op, key, arg, client, ok) int32 words and ``hist_t`` =
int64 sim-time ns, append-ordered by dispatch time. This module is the
numpy side: :class:`BatchHistory` wraps the whole seed batch zero-copy,
and :meth:`BatchHistory.ops` pairs one seed's raw records into
:class:`Op` operations for the linearizability checker.

Record convention (what handlers write via ``EmitBuilder.record`` and
apps via ``check.Recorder``):

* ``ok == OK_PENDING`` (-1): the *invoke* of an operation — the moment
  the client commits to attempting it (e.g. first send of a write).
* ``ok == OK_OK`` (1) / ``OK_FAIL`` (0): a *response*. It closes the
  oldest pending invoke of the same (client, op, key) — FIFO, which is
  exact for clients with one outstanding op per (op, key) (all in-repo
  models, by construction). With several ops concurrently open on one
  (client, op, key) FIFO can mis-pair out-of-order responses, swapping
  their values/intervals — record distinct keys or clients in that
  case, or use ``check.Recorder`` (host-side, token pairing, exact).
  A response with no pending invoke is an *instantaneous* event
  (invoke == response time): the natural encoding for things like
  election wins.

Why two records per op instead of one row with both timestamps: node
state and payloads are int32, so a handler cannot carry an int64 invoke
timestamp to the response site; two append-ordered records need no
state at all, and pairing is a host-side O(n) pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "COL_OP",
    "COL_KEY",
    "COL_ARG",
    "COL_CLIENT",
    "COL_OK",
    "OK_PENDING",
    "OK_FAIL",
    "OK_OK",
    "OP_WRITE",
    "OP_READ",
    "OP_USER",
    "SHARD_EPOCH_SHIFT",
    "SHARD_GROUP_SHIFT",
    "SHARD_GROUP_MASK",
    "SHARD_VER_MASK",
    "pack_shard_own",
    "Op",
    "BatchHistory",
    "HistoryError",
]

# hist_word column layout (engine/core.py history append)
COL_OP, COL_KEY, COL_ARG, COL_CLIENT, COL_OK = range(5)

OK_PENDING = -1  # invoke record of a still-open operation
OK_FAIL = 0  # response: the operation definitely failed
OK_OK = 1  # response: the operation definitely succeeded

# op-kind namespace: the two kinds the built-in checkers understand,
# then a user range for workload-specific events (e.g. raft's ELECT)
OP_WRITE = 1
OP_READ = 2
OP_USER = 16

# Packed arg layout of a shard OWNERSHIP record (models/shardkv.py
# installs, audited by check.shard_coverage): one int32 arg word
# carrying (config epoch, owning group, adopted version). This module
# owns the layout so the recording model and both detector forms
# (numpy + jnp) cannot drift. epoch <= 2047 and version <= 0xFFFF keep
# the word positive in int32.
SHARD_EPOCH_SHIFT = 20
SHARD_GROUP_SHIFT = 16
SHARD_GROUP_MASK = 0xF
SHARD_VER_MASK = 0xFFFF


def pack_shard_own(epoch, group, version):
    """Pack an ownership record's arg word. Works on Python ints,
    numpy arrays (detectors, tests) and traced values (the model)."""
    return (
        (epoch << SHARD_EPOCH_SHIFT)
        | (group << SHARD_GROUP_SHIFT)
        | (version & SHARD_VER_MASK)
    )


class HistoryError(ValueError):
    """A history that violates the recording convention itself."""


@dataclasses.dataclass(frozen=True)
class Op:
    """One paired operation of a single seed's history.

    ``ok == OK_PENDING`` means the invoke never saw a response within
    the recorded window — the op may or may not have taken effect, and
    the linearizability checker treats it as optional.
    """

    client: int
    op: int
    key: int
    arg_inv: int  # invoke-record arg (the input, e.g. the written value)
    arg_res: int  # response-record arg (the output, e.g. the read value)
    ok: int  # OK_OK / OK_FAIL / OK_PENDING
    t_inv: int  # invoke sim-time ns
    t_res: int | None  # response sim-time ns; None while pending
    # buffer indices of the two records: the engine appends in dispatch
    # order (and in record-call order within one handler), so these are
    # a strict refinement of the timestamps — the linearizability
    # checker orders by index, which resolves same-sim-time ties (e.g. a
    # write response and a read invoke recorded by the same handler)
    # exactly instead of conservatively treating them as concurrent
    idx_inv: int = 0
    idx_res: int | None = None


@dataclasses.dataclass
class BatchHistory:
    """Zero-copy numpy view of every seed's recorded history at once.

    The vectorized checkers (check/vectorized.py) consume the raw
    columns directly; :meth:`ops` materializes one seed for the exact
    (and per-seed) linearizability checker.
    """

    word: np.ndarray  # (S, H, 5) int32
    t: np.ndarray  # (S, H) int64
    count: np.ndarray  # (S,) int32 records stored
    drop: np.ndarray  # (S,) int32 records dropped at capacity

    @classmethod
    def from_view(cls, view) -> "BatchHistory":
        """Build from a search/compact result view (field-name mapping)."""
        return cls(
            word=np.asarray(view["hist_word"]),
            t=np.asarray(view["hist_t"]),
            count=np.asarray(view["hist_count"]),
            drop=np.asarray(view["hist_drop"]),
        )

    @classmethod
    def from_state(cls, state) -> "BatchHistory":
        """Build from a batched ``SimState`` (attribute mapping)."""
        return cls(
            word=np.asarray(state.hist_word),
            t=np.asarray(state.hist_t),
            count=np.asarray(state.hist_count),
            drop=np.asarray(state.hist_drop),
        )

    def __len__(self) -> int:
        return int(self.count.shape[0])

    @property
    def n_seeds(self) -> int:
        return len(self)

    def valid(self) -> np.ndarray:
        """(S, H) bool — rows actually written (slot index < count)."""
        h = self.word.shape[1]
        return np.arange(h)[None, :] < self.count[:, None]

    def col(self, c: int) -> np.ndarray:
        """(S, H) int32 — one raw column (COL_* index)."""
        return self.word[:, :, c]

    def overflowed(self) -> np.ndarray:
        """(S,) bool — seeds whose buffer dropped records (verdicts on
        these seeds are unreliable; search_seeds quarantines them)."""
        return self.drop > 0

    def ops(self, s: int, strict: bool = True) -> list[Op]:
        """Pair seed ``s``'s records into operations, in invoke order.

        ``strict=True`` raises :class:`HistoryError` when the seed
        dropped records — a truncated history must not silently verify.
        """
        if strict and self.drop[s] > 0:
            raise HistoryError(
                f"seed index {s} dropped {int(self.drop[s])} history "
                f"records (capacity overflow): history is incomplete"
            )
        n = int(self.count[s])
        word = self.word[s, :n]
        t = self.t[s, :n]
        ops: list[Op] = []
        # open invokes per (client, op, key), FIFO: list of op indices
        pending: dict[tuple, list[int]] = {}
        for i in range(n):
            op_k, key, arg, client, ok = (int(x) for x in word[i])
            ts = int(t[i])
            if ok == OK_PENDING:
                pending.setdefault((client, op_k, key), []).append(len(ops))
                ops.append(
                    Op(client, op_k, key, arg, 0, OK_PENDING, ts, None,
                       idx_inv=i)
                )
            else:
                q = pending.get((client, op_k, key))
                if q:
                    j = q.pop(0)
                    o = ops[j]
                    ops[j] = dataclasses.replace(
                        o, arg_res=arg, ok=ok, t_res=ts, idx_res=i
                    )
                else:
                    # instantaneous event (no separate invoke record)
                    ops.append(Op(client, op_k, key, arg, arg, ok, ts, ts,
                                  idx_inv=i, idx_res=i))
        return ops
