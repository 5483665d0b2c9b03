"""Seed compaction: halted seeds stop costing steps.

Port of ``madsim_tpu/engine/compact.py``. The lockstep loop
(``make_run_while``) steps every seed until the slowest one halts. The
reference's phase program runs the batch in phases of shrinking static
sizes instead:

    phase 0: step S rows          until live <= S/shrink (or the cap)
    compact: stable-partition the live rows to the front, bank the
             halted tail, keep the first S/shrink rows
    phase 1: step S/shrink rows   ...
    last:    step until every row halts (or the cap)

The step cap is one counter shared by all phases. A row keeps stepping
while it is in the batch, halted or not (the "riders" that fill the
head when fewer than ``next_size`` rows are live), so a banked row's
``step`` is its initial step plus the global step count at its bank;
every other banked field is that of the lockstep loop.

Two programs carry it, with equal results in every field, ``step``
included:

* on a CPU state (and on any state through
  :func:`make_run_compacted_plain`), the phase program itself, with the
  plain step;
* on a CUDA state, one launch of the run kernel that stops each seed at
  its own halt (``engine/fused.py``), which is what the phase program
  exists to approximate; no drain kernel, since nothing of the pool is
  banked. That launch gives every banked field but ``step``: a halted
  step changes only ``step`` and ``ev_valid``. :func:`bank_steps`
  rebuilds ``step`` from the kernel's per-seed counts by replaying the
  phase schedule on them, on the host, when ``assemble`` has read the
  counts with the other fields (a few numpy calls a phase, where the
  device would take some twenty small launches).

With ``hist_screen`` every bank is judged by the history screens
(``check/device.py``) on its own device before anything is copied, and
the clean seeds' responded operations fold out of the banked history
columns (:func:`check.device.fold_verified`): two more result fields,
``hist_ok`` and ``hist_fold``. On the card the one bank holds every
row's final history; a halted row records nothing more, so its verdict
and folded columns equal the phase program's.

``run.compute(state)`` returns the banks (device tensors, each with its
rows' original indices under ``"_idx"``); ``run.assemble(banks)``
scatters them back to seed order as numpy arrays with the JAX package's
dtypes; ``run(state)`` is both. ``run.phases`` is ``run.compute`` under
the name of the JAX package's phase-program seam (``compiled``); the
same program serves a whole batch or one rank's shard
(``parallel.shard_run_compacted``).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..check.device import as_screens, fold_verified, screen_ok
from .convert import field_to_numpy
from .core import STATE_FIELDS, EngineConfig, SimState, Workload, make_step_plain
from .rng import M32

__all__ = [
    "RESULT_FIELDS",
    "SCREEN_FIELDS",
    "bank_steps",
    "make_run_compacted",
    "make_run_compacted_plain",
    "one_launch_banks",
]

# the reference's RESULT_FIELDS. cov_hits is not banked (the reference's rule: guidance reads only the
# bitmap), nor is the pool's ev_emit; of the latency tap the sketch and
# its counters are, the per-op clocks are not (banked sweeps read only
# the sketch); of the causal columns the final clocks and the ring's
# three are, the pool's sidecars are not (they read only against a pool
# the bank drops)
RESULT_FIELDS = (
    "seed", "now", "step", "halted", "halt_time", "trace", "overflow",
    "msg_count", "node_state", "disk", "hist_count", "hist_drop", "hist_word",
    "hist_t", "cov", "met", "tl_count", "tl_drop", "tl_t", "tl_meta", "tl_args",
    "tl_pay", "tl_emit", "lam", "tl_seq", "tl_parent", "tl_lam", "lat_hist", "lat_count",
    "lat_drop",
)

# the extra banked outputs of a ``hist_screen`` run (not SimState
# fields): each seed's verdict and the records the fold took out
SCREEN_FIELDS = ("hist_ok", "hist_fold")
HIST_FIELDS = ("hist_word", "hist_t", "hist_count", "hist_drop")

def _phase_sizes(s0: int, shrink: int, min_size: int) -> list[int]:
    sizes = [s0]
    while sizes[-1] // shrink >= min_size:
        sizes.append(sizes[-1] // shrink)
    return sizes


def _check(fields, shrink: int, min_size: int) -> None:
    for f in fields:
        if f not in RESULT_FIELDS:
            raise ValueError(
                f"unknown result field {f!r}; the compacted runner banks "
                f"{RESULT_FIELDS}"
            )
    if shrink < 2:
        raise ValueError(f"shrink must be >= 2, got {shrink}")
    if min_size < 1:
        raise ValueError(f"min_size must be >= 1, got {min_size}")


def bank_steps(counts: np.ndarray, sizes, max_steps: int) -> np.ndarray:
    """The global step count at which the phase program banks each row.

    ``counts`` are each row's steps until it halts, at most
    ``max_steps`` (the run kernel's stop-at-halt counts); ``sizes`` is
    the phase schedule. After ``t`` global steps a row is live iff its
    count exceeds ``t``, so a phase that starts at ``i`` ends at the
    first ``t >= i`` at which at most ``next_size`` of its rows are
    live (the cap at the latest), read off a histogram of their counts;
    the head is the live rows and then the first halted ones, each in
    the current order.
    """
    counts = np.asarray(counts, np.int64)
    bank = np.zeros_like(counts)
    idx = np.arange(counts.shape[0])
    i = 0
    for next_size in [*sizes[1:], 0]:
        c = counts[idx]
        hist = np.bincount(c, minlength=max_steps + 1)[: max_steps + 1]
        live_after = c.shape[0] - np.cumsum(hist)  # rows with c > t
        i += int(np.argmax(live_after[i:] <= next_size))
        if next_size == 0:
            bank[idx] = i
            break
        live = c > i
        moved = np.concatenate([idx[live], idx[~live]])
        bank[moved[next_size:]] = i
        idx = moved[:next_size]
    return bank


def _rows(st: SimState, rows) -> SimState:
    return SimState(**{f: getattr(st, f)[rows] for f in STATE_FIELDS})


def _to_numpy(f: str, t: torch.Tensor) -> np.ndarray:
    # the screen outputs are no SimState fields: bool verdicts, int32 folds
    return t.cpu().numpy() if f in SCREEN_FIELDS else field_to_numpy(f, t)


def _runner(compute, fields, shrink: int, min_size: int, max_steps: int,
            screened: bool = False):
    out_fields = tuple(fields) + SCREEN_FIELDS if screened else tuple(fields)

    def assemble(banked) -> SimpleNamespace:
        """Device to host, and scatter back into original seed order;
        the card's one bank gets each row's step rebuilt. Under a
        ``hist_screen`` the history columns are copied only up to the
        longest surviving ``hist_count`` (read first); the fold left the
        rows past it zero, as the host buffer's tail is."""
        s0 = sum(b["_idx"].shape[0] for b in banked)
        idx = [b["_idx"].cpu().numpy() for b in banked]
        kept = None
        if screened:
            kept = max(int(b["hist_count"].max()) if b["hist_count"].numel() else 0
                       for b in banked)
        out = {}
        for f in out_fields:
            trim = kept if f in ("hist_word", "hist_t") else None
            parts = [_to_numpy(f, b[f] if trim is None else b[f][:, :trim]) for b in banked]
            buf = np.zeros((s0, *banked[0][f].shape[1:]), parts[0].dtype)
            for ix, v in zip(idx, parts):
                if trim is None:
                    buf[ix] = v
                else:
                    buf[ix, :trim] = v
            out[f] = buf
        if "_iters" in banked[0]:
            sizes = _phase_sizes(s0, shrink, min_size)
            bank = bank_steps(banked[0]["_iters"].cpu().numpy(), sizes, max_steps)
            out["step"] = ((out["step"].astype(np.int64) + bank) & M32).astype(np.uint32)
        return SimpleNamespace(**out)

    def run(state: SimState) -> SimpleNamespace:
        return assemble(compute(state))

    # benchmark seam: time `compute` (device work only) and call
    # `assemble` outside the window
    run.compute = compute
    run.assemble = assemble
    return run


def _screens(wl: Workload, hist_screen, fields):
    """The validated screen tuple of ``hist_screen``, or None."""
    if hist_screen is None:
        return None
    if wl.history is None:
        raise ValueError(
            f"hist_screen judges operation histories, but workload "
            f"{wl.name!r} has Workload.history=None"
        )
    screens = as_screens(hist_screen)
    missing = [f for f in HIST_FIELDS if f not in fields]
    if missing:
        raise ValueError(
            f"hist_screen needs the history columns banked; fields is "
            f"missing {missing}"
        )
    return screens


def _screen_bank(bank: dict, screens) -> dict:
    """Judge a bank's histories where they lie, then fold the clean
    seeds' responded operations out of its columns. The verdict judges
    the full history, as screening the uncompacted run would."""
    cols = [bank[f] for f in HIST_FIELDS]
    ok = screen_ok(screens, *cols)
    word, t, count, fold = fold_verified(*cols, ok)
    return {**bank, "hist_word": word, "hist_t": t, "hist_count": count,
            "hist_ok": ok, "hist_fold": fold}


def _phase_program(wl: Workload, cfg: EngineConfig, max_steps: int,
                   shrink: int, min_size: int, fields, dup_rows: bool = False,
                   metrics: bool = False, **obs):
    step = make_step_plain(wl, cfg, dup_rows, metrics, **obs)

    def compute(state: SimState) -> list:
        s0 = state.seed.shape[0]
        idx = torch.arange(s0, device=state.device)
        st, i, banked = state, 0, []
        for next_size in [*_phase_sizes(s0, shrink, min_size)[1:], 0]:
            while i < max_steps and int((~st.halted).sum()) > next_size:
                st = step(st)
                i += 1
            if next_size == 0:
                banked.append({**{f: getattr(st, f) for f in fields}, "_idx": idx})
                break
            # stable partition: live rows first, the halted tail banked;
            # the kept prefix keeps the lockstep batch's row order
            order = torch.argsort(st.halted.to(torch.int8), stable=True)
            tail, head = order[next_size:], order[:next_size]
            banked.append({**{f: getattr(st, f)[tail] for f in fields}, "_idx": idx[tail]})
            st, idx = _rows(st, head), idx[head]
        return banked

    return compute


def make_run_compacted_plain(
    wl: Workload, cfg: EngineConfig, max_steps: int, shrink: int = 4,
    min_size: int = 2048, fields: tuple = RESULT_FIELDS, dup_rows: bool = False,
    metrics: bool = False, cov_words: int = 0, timeline_cap: int = 0,
    cov_hitcount: bool = False, latency=None, causal: bool = False, retry=None,
):
    """The phase program with the plain eager step, on any device."""
    _check(fields, shrink, min_size)
    compute = _phase_program(wl, cfg, max_steps, shrink, min_size, fields, dup_rows,
                             metrics, cov_words=cov_words, timeline_cap=timeline_cap,
                             cov_hitcount=cov_hitcount, latency=latency, causal=causal,
                             retry=retry)
    return _runner(compute, fields, shrink, min_size, max_steps)


def make_run_compacted(
    wl: Workload,
    cfg: EngineConfig,
    max_steps: int,
    shrink: int = 4,
    min_size: int = 2048,
    fields: tuple = RESULT_FIELDS,
    dup_rows: bool = False,
    cov_words: int = 0,
    metrics: bool = False,
    timeline_cap: int = 0,
    cov_hitcount: bool = False,
    latency=None,
    hist_screen=None,
    causal: bool = False,
    retry=None,
):
    """Build ``run(state) -> SimpleNamespace`` of per-original-seed
    results: one numpy array per name in ``fields``, in seed order.

    ``shrink``/``min_size`` set the phase schedule; with ``min_size >=
    n_seeds`` it is one phase, ``make_run_while`` by another name. A CPU
    state runs the phase program with the plain step; a CUDA state
    launches the run kernel once (or raises for a workload the kernel
    does not carry). A fault plan's rows come in the state from
    ``make_init(plan_slots=...)``; ``dup_rows`` runs the step with the
    duplication rows (a plan with ``Duplicate`` needs them).
    ``metrics`` folds the fleet counters (a state from
    ``make_init(metrics=True)``); ``met`` is banked with the others. A
    halted row's counters stop, so they equal the lockstep loop's.
    ``cov_words`` (with ``cov_hitcount``) and ``timeline_cap`` run the
    coverage taps and the timeline ring (a state from ``make_init`` with
    the same arguments); ``cov`` and the ring's ``tl_*`` columns are
    banked, the hit counters are not. A halted row dispatches nothing, so
    its bitmap and ring stop too. ``latency`` runs the tail-latency tap
    (a state from ``make_init(latency=...)``); ``lat_hist``,
    ``lat_count`` and ``lat_drop`` are banked, the per-op clocks are not.
    ``causal`` runs the causal fold (a state from ``make_init(causal=
    True)``); the final clocks ``lam`` and the ring's ``tl_seq``,
    ``tl_parent`` and ``tl_lam`` are banked, the pool's sidecars are not.

    ``hist_screen`` (a ``check.device.HistoryScreen`` or a tuple of
    them) screens every bank's histories on its device and folds the
    clean seeds' responded operations out of the banked columns, so the
    copy to the host carries the pending invokes and the flagged seeds'
    full histories. It adds ``hist_ok`` (the verdict, taken before the
    fold) and ``hist_fold`` (records folded: the original count is
    ``hist_count + hist_fold``). Flagged and overflowed seeds keep every
    record. It needs ``wl.history`` and the four history fields.

    ``retry`` (a ``RetrySpec``) runs the client-retry timers (a state
    from ``make_init(retry=...)``); as in the reference, their columns
    are not banked (``met`` carries the retry counters).
    """
    _check(fields, shrink, min_size)
    screens = _screens(wl, hist_screen, fields)
    obs = dict(cov_words=cov_words, timeline_cap=timeline_cap, cov_hitcount=cov_hitcount,
               latency=latency, causal=causal, retry=retry)
    plain = _phase_program(wl, cfg, max_steps, shrink, min_size, fields, dup_rows,
                           metrics, **obs)

    def compute(state: SimState) -> list:
        if state.device.type == "cpu":
            banks = plain(state)
        else:
            from .fused import _first_pass, check_taps

            check_taps(state, metrics, **obs)
            _spec, out, iters, _tmax = _first_pass(wl, cfg, state, max_steps, True,
                                                   dup_rows, latency, retry)
            banks = one_launch_banks(state, out, iters, fields)
        if screens is None:
            return banks
        return [_screen_bank(b, screens) for b in banks]

    run = _runner(compute, fields, shrink, min_size, max_steps, screens is not None)
    run.phases = compute
    return run


def one_launch_banks(state: SimState, out: SimState, iters: torch.Tensor, fields) -> list:
    """The card path's banks from one stop-at-halt run of ``state``
    (``out``, with each seed's step count in ``iters``): one bank in
    seed order whose ``step`` is the initial one, and the counts, from
    which ``assemble`` rebuilds each row's step with :func:`bank_steps`."""
    bank = {f: getattr(out, f) for f in fields if f != "step"}
    if "step" in fields:
        bank["step"], bank["_iters"] = state.step, iters
    bank["_idx"] = torch.arange(state.seed.shape[0], device=state.device)
    return [bank]
