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

``run.compute(state)`` returns the banks (device tensors, each with its
rows' original indices under ``"_idx"``); ``run.assemble(banks)``
scatters them back to seed order as numpy arrays with the JAX package's
dtypes; ``run(state)`` is both.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .convert import FOREIGN_FIELDS, field_to_numpy
from .core import STATE_FIELDS, EngineConfig, SimState, Workload, make_step_plain
from .rng import M32

__all__ = [
    "RESULT_FIELDS",
    "UNPORTED_OPTIONS",
    "bank_steps",
    "make_run_compacted",
    "make_run_compacted_plain",
    "one_launch_banks",
    "refuse_unported",
]

# the reference's RESULT_FIELDS that the port's SimState has; the
# reference's others are zero-size for every variant the port runs
RESULT_FIELDS = (
    "seed", "now", "step", "halted", "halt_time", "trace", "overflow",
    "msg_count", "node_state", "hist_count", "hist_drop", "hist_word",
    "hist_t",
)

# options of the reference's runners whose engine axes the port does not
# have yet, and the ROADMAP queue A item that ports each
UNPORTED_OPTIONS = {
    "plan": "A8", "plan_slots": "A8", "plan_rows": "A8", "plan_hash": "A8",
    "dup_rows": "A8",
    "device_check": "A13", "hist_screen": "A13",
    "cov_words": "A8", "cov_hitcount": "A8", "metrics": "A8",
    "timeline_cap": "A8", "latency": "A8", "causal": "A8", "retry": "A8",
}


def refuse_unported(**options) -> None:
    """Raise ``NotImplementedError`` for any option of
    :data:`UNPORTED_OPTIONS` given a value other than its off value."""
    for name, value in options.items():
        if value is None or (isinstance(value, (int, str)) and not value):
            continue
        raise NotImplementedError(
            f"{name}= needs an engine axis the torch port does not have "
            f"yet, until ROADMAP item {UNPORTED_OPTIONS[name]}"
        )


def _phase_sizes(s0: int, shrink: int, min_size: int) -> list[int]:
    sizes = [s0]
    while sizes[-1] // shrink >= min_size:
        sizes.append(sizes[-1] // shrink)
    return sizes


def _check(fields, shrink: int, min_size: int) -> None:
    for f in fields:
        if f in FOREIGN_FIELDS:
            raise NotImplementedError(
                f"result field {f!r} is not in the torch port's SimState "
                f"until ROADMAP item {FOREIGN_FIELDS[f][2]}"
            )
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


def _runner(compute, fields, shrink: int, min_size: int, max_steps: int):
    def assemble(banked) -> SimpleNamespace:
        """Device to host, and scatter back into original seed order;
        the card's one bank gets each row's step rebuilt."""
        s0 = sum(b["_idx"].shape[0] for b in banked)
        idx = [b["_idx"].cpu().numpy() for b in banked]
        out = {}
        for f in fields:
            parts = [field_to_numpy(f, b[f]) for b in banked]
            buf = np.zeros((s0, *parts[0].shape[1:]), parts[0].dtype)
            for ix, v in zip(idx, parts):
                buf[ix] = v
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


def _phase_program(wl: Workload, cfg: EngineConfig, max_steps: int,
                   shrink: int, min_size: int, fields):
    step = make_step_plain(wl, cfg)

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
    min_size: int = 2048, fields: tuple = RESULT_FIELDS,
):
    """The phase program with the plain eager step, on any device."""
    _check(fields, shrink, min_size)
    compute = _phase_program(wl, cfg, max_steps, shrink, min_size, fields)
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
    does not carry). The options after ``fields`` raise
    ``NotImplementedError`` until their engine axes are ported.
    """
    refuse_unported(
        dup_rows=dup_rows, cov_words=cov_words, metrics=metrics,
        timeline_cap=timeline_cap, cov_hitcount=cov_hitcount,
        latency=latency, hist_screen=hist_screen, causal=causal, retry=retry,
    )
    _check(fields, shrink, min_size)
    plain = _phase_program(wl, cfg, max_steps, shrink, min_size, fields)

    def compute(state: SimState) -> list:
        if state.device.type == "cpu":
            return plain(state)
        from .fused import _first_pass

        _spec, out, iters, _tmax = _first_pass(wl, cfg, state, max_steps, True)
        return one_launch_banks(state, out, iters, fields)

    return _runner(compute, fields, shrink, min_size, max_steps)


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
