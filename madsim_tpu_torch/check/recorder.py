"""Single-seed operation recorder for asyncio-level applications.

The batched engine records histories on-device (engine/core.py); apps
on the single-seed runtime (madsim_tpu_torch.runtime — real coroutines, RPC,
fs) record them with this class instead, producing the *same* history
representation so the same checkers validate both execution modes:

    rec = check.Recorder()
    tok = rec.invoke(client=0, op=check.OP_WRITE, key=1, arg=42)
    r = await kv_put(...)            # the operation itself
    rec.respond(tok, ok=True, value=42)
    ...
    assert rec.check_kv().ok         # Wing–Gong over the full history

Timestamps default to the simulation's virtual clock
(``madsim_tpu_torch.runtime.now_ns``), so histories are deterministic per
seed exactly like everything else in the runtime; pass ``clock=`` to
record outside a simulation.
"""

from __future__ import annotations

import dataclasses

from .history import (
    OK_FAIL,
    OK_OK,
    OK_PENDING,
    BatchHistory,
    Op,
)
from .linearize import LinResult, check_kv, check_register

__all__ = ["Recorder"]

import numpy as np


class Recorder:
    """Append-only history of (op, key, arg, client, ok, t) records.

    Mirrors the engine's on-device columns, unbounded (host memory is
    not a fixed-size arena, so there is no overflow path here).
    """

    def __init__(self, clock=None):
        if clock is None:
            from ..runtime import now_ns as clock  # virtual sim clock
        self._clock = clock
        self._rows: list[tuple[int, int, int, int, int, int]] = []
        self._open: set[int] = set()  # open tokens (= invoke row indices)
        self._pair: dict[int, int] = {}  # response row -> invoke row

    def _append(self, op, key, arg, client, ok) -> int:
        self._rows.append(
            (int(op), int(key), int(arg), int(client), int(ok),
             int(self._clock()))
        )
        return len(self._rows) - 1

    def invoke(self, client: int, op: int, key: int = 0, arg: int = 0) -> int:
        """Record an operation invocation; returns a token for respond()."""
        tok = self._append(op, key, arg, client, OK_PENDING)
        self._open.add(tok)
        return tok

    def respond(self, token: int, ok: bool = True, value: int = 0) -> None:
        """Record the response of a previously invoked operation."""
        if token not in self._open:
            raise ValueError(f"token {token} is not an open invocation")
        self._open.remove(token)
        op, key, _arg, client, _ok, _t = self._rows[token]
        i = self._append(op, key, value, client, OK_OK if ok else OK_FAIL)
        self._pair[i] = token

    def event(self, client: int, op: int, key: int = 0, arg: int = 0,
              ok: bool = True) -> None:
        """Record an instantaneous operation (invoke == response)."""
        self._append(op, key, arg, client, OK_OK if ok else OK_FAIL)

    # ---- checker bridge ------------------------------------------------
    def to_batch(self) -> BatchHistory:
        """This history as a 1-seed :class:`BatchHistory` (seed axis 0).

        Note ``BatchHistory.ops`` re-pairs by the engine's FIFO
        convention; the raw columns (what the vectorized checkers read)
        are exact either way. For exact pairing use :meth:`ops`.
        """
        n = len(self._rows)
        word = np.zeros((1, n, 5), np.int32)
        t = np.zeros((1, n), np.int64)
        for i, (op, key, arg, client, ok, ts) in enumerate(self._rows):
            word[0, i] = (op, key, arg, client, ok)
            t[0, i] = ts
        return BatchHistory(
            word=word, t=t,
            count=np.array([n], np.int32),
            drop=np.zeros((1,), np.int32),
        )

    def ops(self) -> list[Op]:
        """Paired operations, in invoke order.

        Unlike the engine columns (where handlers cannot carry a row
        index to the response site, so ``BatchHistory.ops`` pairs FIFO
        per (client, op, key)), the Recorder knows each response's
        invoke row from its token — pairing here is exact even with
        several concurrent ops on one (client, key)."""
        ops: list[Op] = []
        slot: dict[int, int] = {}  # invoke row index -> position in ops
        for i, (op, key, arg, client, ok, ts) in enumerate(self._rows):
            if ok == OK_PENDING:
                slot[i] = len(ops)
                ops.append(
                    Op(client, op, key, arg, 0, OK_PENDING, ts, None,
                       idx_inv=i)
                )
            elif i in self._pair:
                j = slot[self._pair[i]]
                ops[j] = dataclasses.replace(
                    ops[j], arg_res=arg, ok=ok, t_res=ts, idx_res=i
                )
            else:
                # instantaneous event() (invoke == response)
                ops.append(Op(client, op, key, arg, arg, ok, ts, ts,
                              idx_inv=i, idx_res=i))
        return ops

    def check_register(self, init: int = 0) -> LinResult:
        return check_register(self.ops(), init=init)

    def check_kv(self, init: int = 0) -> LinResult:
        return check_kv(self.ops(), init=init)

    def __len__(self) -> int:
        return len(self._rows)
