"""Wing–Gong linearizability checker for register and KV histories.

A copy of the JAX package's ``madsim_tpu/check/linearize.py`` (numpy only):
the torch port imports nothing of that package, whose ``check``
loads JAX through its device screens.

The exact, per-seed checker: given one seed's paired operations
(:meth:`check.history.BatchHistory.ops`), decide whether there exists a
linearization — a total order of the operations that (a) respects
real-time precedence (op A completed before op B was invoked ⇒ A
before B) and (b) is a legal sequential execution of the model
(int-valued registers; KV = one register per key).

The algorithm is the Wing–Gong recursion with porcupine's memoization:
repeatedly pick a *minimal* operation (one invoked before every
still-unlinearized definite operation's response), apply it to the
model state, recurse; prune on (remaining-set, state) pairs already
proven dead. Real-time precedence is judged by the operations' record
*indices* (``Op.idx_inv``/``Op.idx_res``), not raw timestamps: the
engine appends history records in dispatch order, so indices are a
strict refinement of sim-time that resolves same-timestamp ties (a
write response and a read invoke recorded by one handler) exactly. Worst case exponential like every linearizability check
(the problem is NP-complete); the histories the batched models record
are small (tens of ops, few clients) and check in microseconds. For
whole-batch sweeps use the cheap vectorized detectors first
(check/vectorized.py) and reserve this checker for flagged seeds — or
run it everywhere when the op counts are small (tools/check_soak.py
does).

Uncertain operations:

* pending ops (invoked, never responded) **may or may not** have taken
  effect — the search may linearize them anywhere after their invoke
  or drop them entirely (the FoundationDB "maybe committed" case);
* explicitly failed writes (``ok == OK_FAIL``) are treated the same
  way (a failed response proves nothing about the effect);
* failed/pending reads constrain nothing (their output was never
  observed) and are discarded.
"""

from __future__ import annotations

import dataclasses

from .history import OK_FAIL, OK_OK, OK_PENDING, OP_READ, OP_WRITE, Op

__all__ = ["LinResult", "check_register", "check_kv"]

_T_INF = 2**63  # "never responded" for real-time ordering purposes


@dataclasses.dataclass(frozen=True)
class LinResult:
    """Verdict of one linearizability check."""

    ok: bool
    n_ops: int  # ops the search actually had to order (definite+optional)
    reason: str | None = None

    def __bool__(self) -> bool:
        return self.ok


def check_register(ops: list[Op], init: int = 0) -> LinResult:
    """Linearizability of a single int register (ignores ``Op.key``).

    write(v): always legal, sets the register. read()->v: legal iff the
    register holds v. ``init`` is the register's initial value.
    """
    definite: list[Op] = []
    optional: list[Op] = []
    for o in ops:
        if o.op not in (OP_READ, OP_WRITE):
            raise ValueError(
                f"check_register only models OP_READ/OP_WRITE histories, "
                f"got op kind {o.op} — filter workload-specific events "
                f"out (or check them with check.vectorized)"
            )
        if o.ok == OK_OK:
            definite.append(o)
        elif o.op == OP_WRITE and o.ok in (OK_PENDING, OK_FAIL):
            optional.append(o)
        # pending/failed reads: no observed output, no constraint
    items = definite + optional
    n = len(items)
    if n > 63:
        raise ValueError(
            f"{n} ops exceed the 63-op bitmask bound of this checker; "
            f"shard the history (e.g. per key via check_kv) first"
        )
    nd = len(definite)
    t_inv = [o.idx_inv for o in items]
    # optional ops get an infinite response for ordering: their effect
    # window is open-ended, so they never constrain the frontier (the
    # conservative — more permissive, no-false-violation — choice)
    t_res = [
        (o.idx_res if i < nd and o.idx_res is not None else _T_INF)
        for i, o in enumerate(items)
    ]
    definite_mask = (1 << nd) - 1
    full_mask = (1 << n) - 1
    seen: set = set()

    def dfs(rem: int, state: int) -> bool:
        rem_def = rem & definite_mask
        if rem_def == 0:
            return True  # leftover optional ops simply never took effect
        if (rem, state) in seen:
            return False
        seen.add((rem, state))
        # frontier: an op is minimal iff invoked no later than every
        # remaining definite op's response
        bound = min(t_res[j] for j in _bits(rem_def))
        for i in _bits(rem):
            if t_inv[i] > bound:
                continue
            o = items[i]
            if o.op == OP_WRITE:
                if dfs(rem & ~(1 << i), o.arg_inv):
                    return True
            elif o.arg_res == state:
                if dfs(rem & ~(1 << i), state):
                    return True
        return False

    if dfs(full_mask, init):
        return LinResult(True, n)
    return LinResult(
        False,
        n,
        f"no linearization of {nd} completed ops "
        f"(+{n - nd} maybe-applied) exists for register init={init}",
    )


def check_kv(ops: list[Op], init: int = 0) -> LinResult:
    """Linearizability of a KV store: one independent register per key.

    Keys never interact in the sequential model, so the history
    partitions exactly and each key checks separately (this is also
    what keeps the exponential worst case at bay).
    """
    by_key: dict[int, list[Op]] = {}
    for o in ops:
        by_key.setdefault(o.key, []).append(o)
    total = 0
    for key, kops in sorted(by_key.items()):
        r = check_register(kops, init=init)
        total += r.n_ops
        if not r.ok:
            return LinResult(False, total, f"key {key}: {r.reason}")
    return LinResult(True, total)


def _bits(mask: int):
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low
