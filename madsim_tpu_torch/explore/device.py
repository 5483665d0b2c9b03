"""Device-resident exploration campaigns — one host sync per generation.

Port of ``madsim_tpu/explore/device.py``. The host driver
(explore/driver.py) round-trips through numpy every generation: corpus
selection, mutation and admission all run on the host while the card
idles, and the whole per-seed result state crosses to the host each
dispatch. This module is the same campaign loop restated as torch ops
on the seeds' device:

* the **corpus lives in device memory** as fixed-capacity column
  tensors (plan rows, seeds, traces, coverage signatures, ids — one row
  per admitted entry, plus a trash row that refused candidates are
  scattered to and that is never read);
* **mutation** is a batched torch mutator (:func:`_make_child_mutator`)
  that emulates the host edit script *draw for draw*: the same threefry
  counters, the same modulo reductions, the same branch structure as
  ``HostStream`` + ``mutate_plan`` — so a device campaign breeds
  bit-identical children (the parity test pins it);
* **admission** is an exclusive prefix OR and a popcount over the
  generation in batch order, with the (seed, trace) violation dedup
  against the store and against earlier children of the same batch,
  and the winners scattered into the stores;
* each generation — derive keys, pick parents, mutate (or compile the
  uniform generation's plan with ``compile_batch(device=True)``),
  simulate (``engine.make_sweep``, the run kernel on the card), judge,
  admit — is built once per campaign *shape* and served from the
  generation-program cache (``_GEN_CACHE``, the ``engine.search``
  discipline): the campaign root seed and generation index are runtime
  arguments, so a session of campaigns over fresh root seeds builds
  nothing again (``compile_wall_s`` is the seconds spent building and
  loading the kernel library, 0.0 once it is loaded).

The host sees exactly one synchronization point per generation: the
admission summary (corpus size, next id, violation count, admitted
entries, coverage bits, the overflow flag) as one small tensor.
Per-seed state never reaches the host until the final report (or a
checkpoint) materializes the corpus once.

Campaign outcomes are **bit-identical to the host driver** given the
same arguments: same corpus (ids, seeds, plans, traces, new-bit
scores), same coverage map, same violations, same replay keys — the
device path is a lowering, not a fork. ``checkpoint_path`` / ``resume``
interoperate with host-driver checkpoints (and the JAX package's) in
both directions.

History hunts go device-resident too: ``history_check`` (a
``check.device.HistoryScreen`` set) runs the batched detectors on the
sweep's history columns right where they were recorded. Finds replay
on the host driver via ``check.device.screens_invariant(screens)`` —
bit-identical verdicts, so the two drivers agree corpus-for-corpus.

Limitations vs the host driver: the invariant must be a final-state
predicate over the tensor view (``{field: tensor} -> (S,) bool``, torch
ops on the sweep's device); arbitrary host ``history_invariant``
callables beyond the screen set need the host driver, and
``compact=True`` has no device equivalent (the sweep runs
``make_run_while``).

With a ``mesh`` (``parallel.make_mesh``: a ``torch.distributed`` world)
each rank simulates its shard of every generation's children and the
per-child admission inputs are all-gathered, so every rank's corpus,
coverage map, stores and report equal the unsharded campaign's. The
pipelined schedule of the same session is ``farm.run_pipelined``.
"""

from __future__ import annotations

import functools
import os as _os
import time as _time
from contextlib import contextmanager

import numpy as np
import torch

from ..chaos.plan import FaultEvent, FaultPlan, LiteralPlan, stack_plan_rows
from ..engine.core import PlanRows, host_to_device, resolve_device
from ..engine.rng import M32, PURPOSE_EXPLORE, threefry2x32
from ..engine.search import _library_build_s, launch_cost, make_sweep
from .coverage import popcount32, prefix_or
from .driver import CorpusEntry, ExploreReport, _pad_literal
from .mutate import (
    MODE_NODE,
    MODE_PAIR,
    MODE_RETIME,
    MODE_SKEW,
    MODE_SLOW,
    PlanSpace,
    inherit_threshold,
    mutation_table,
)

__all__ = ["counted_syncs", "gen_cache_stats", "run_device", "strict_syncs"]

_I64 = torch.int64
# the parts of a generation, timed into every telemetry record
PARTS = ("mutate", "compile", "sweep", "judge", "admit")


def _kth_true(mask, k):
    """Per row, the index of the (k+1)-th True of ``mask`` (B, P) — the
    device form of the host's ``index_list[k]`` pick (callers guarantee
    k < the row's count). argmax on int64 returns the first maximum."""
    cum = torch.cumsum(mask.to(_I64), dim=1)
    return torch.argmax((mask & (cum == k[:, None] + 1)).to(_I64), dim=1)


def _mk_seeds(k0s, k1s):
    # uint64 bit patterns in int64: the shift wraps into the sign bit
    return k0s | (k1s << 32)


# ---------------------------------------------------------------------------
# the batched mutator — HostStream + mutate_plan, draw for draw
# ---------------------------------------------------------------------------


def _make_child_mutator(tb, max_ops: int, inherit_thresh: int):
    """Build ``children(k0s, k1s, fresh, order, olen, store) -> dict``
    — the batched form of every batch slot's host edit script:

        st = HostStream(k0, k1, PURPOSE_EXPLORE)
        pid = order[st.bits() % len(order)]          # draw 0
        inherit = st.bits() < inherit_thresh          # draw 1
        child = mutate_plan(parent, space, st, ...)   # draws 2..

    Every draw is ``threefry2x32(k0, k1, j, PURPOSE_EXPLORE)[0]`` at
    the same running counter ``j`` the HostStream would use; branches
    advance ``j`` by exactly the number of draws the host branch
    consumes (``mutate.RETARGET_DRAWS``), so the two edit scripts stay
    aligned no matter which ops fire. The loop over ``max_ops`` runs
    every op step for every child, masked by its own op count.
    """
    x1 = PURPOSE_EXPLORE
    t_lo, t_hi = tb["t_lo"], tb["t_hi"]
    mode, rt_d = tb["mode"], tb["rt_draws"]
    tgt, tcnt = tb["tgt"], tb["tcnt"]
    mult_lo, mult_hi = tb["mult_lo"], tb["mult_hi"]
    skew_lo, skew_hi = tb["skew_lo"], tb["skew_hi"]
    p_slots = int(t_lo.shape[0])
    width = torch.arange(tgt.shape[1], device=tgt.device)
    lanes = torch.arange(7, device=tgt.device)

    def bits(k0, k1, j):
        return threefry2x32(k0, k1, j, x1)[0]

    def children(k0s, k1s, fresh, order, olen, cr):
        b = k0s.shape[0]
        rows = torch.arange(b, device=k0s.device)
        pslot = order[bits(k0s, k1s, 0) % olen]
        inherit = bits(k0s, k1s, 1) < inherit_thresh
        seed = torch.where(inherit, cr["seed"][pslot], fresh)
        halt = cr["halt"][pslot]
        has_h = halt > 0
        n_ops = 1 + bits(k0s, k1s, 2) % max(max_ops, 1)

        def retime(sel, told, cw, vw):
            lo = t_lo[sel]
            hi0 = t_hi[sel]
            # the parent's causal window: an event past the halt clock
            # can never change the trajectory (mutate._retime)
            hi = torch.where(has_h & (lo < halt) & (halt < hi0), halt, hi0)
            delta = torch.clamp((hi - lo) // 8, min=1)
            tf = torch.minimum(torch.maximum(told + (vw % (2 * delta + 1) - delta), lo),
                               hi - 1)
            tc = lo + vw % torch.clamp(hi - lo, min=1)
            return torch.where(cw % 2 == 0, tf, tc)

        t = cr["time"][pslot].clone()
        a0 = cr["args"][pslot, :, 0].to(_I64)
        a1 = cr["args"][pslot, :, 1].to(_I64)
        en = cr["valid"][pslot].clone()
        j = torch.full((b,), 3, dtype=_I64, device=k0s.device)
        for it in range(max(max_ops, 1)):
            active = it < n_ops
            w = bits(k0s[:, None], k1s[:, None], (j[:, None] + lanes) & M32)
            op = w[:, 0] % 8
            n_on = en.sum(1)
            n_off = p_slots - n_on
            alive = en & (t < halt[:, None])
            n_alive = alive.sum(1)
            use_alive = has_h & (n_alive > 0)
            sel_mask = torch.where(use_alive[:, None], alive, en)
            sel_cnt = torch.where(use_alive, n_alive, n_on)
            # mutate_plan's if/elif chain, one branch per op
            b_add = (op == 0) & (n_off > 0)
            b_drop = (op == 1) & (n_on > 1)
            b_ret = ((op == 2) | (op == 3)) & (n_on > 0)
            b_time = ~(b_add | b_drop | b_ret) & (n_on > 0)
            b_fadd = ~(b_add | b_drop | b_ret | b_time) & (n_off > 0)
            any_add = b_add | b_fadd
            k_off = w[:, 1] % torch.clamp(n_off, min=1)
            k_on = w[:, 1] % torch.clamp(sel_cnt, min=1)
            sel = torch.where(any_add, _kth_true(~en, k_off), _kth_true(sel_mask, k_on))
            m = mode[sel]
            rd = rt_d[sel]
            is_fb = m == MODE_RETIME
            t_sel = t[rows, sel]
            # add/force-add and plain-retime both draw (choose, value)
            # at w[2], w[3]; retarget draws start at w[4] after an add's
            # retime, at w[2] otherwise
            t_rt1 = retime(sel, t_sel, w[:, 2], w[:, 3])
            rw0 = torch.where(any_add, w[:, 4], w[:, 2])
            rw1 = torch.where(any_add, w[:, 5], w[:, 3])
            rw2 = torch.where(any_add, w[:, 6], w[:, 4])
            # fallback retarget = a second retime (reading the time the
            # add's first retime just wrote, exactly like the host's
            # in-place event list)
            t_fb = retime(sel, torch.where(any_add, t_rt1, t_sel), rw0, rw1)
            aa = tgt[sel, rw0 % torch.clamp(tcnt[sel], min=1)]
            # the host's [t for t in targets if t != a] pick: exclusion
            # is by VALUE, order preserved
            row = tgt[sel]
            ok = (width < tcnt[sel][:, None]) & (row != aa[:, None])
            bb = row[rows, _kth_true(ok, rw1 % torch.clamp(ok.sum(1), min=1))]
            mult = mult_lo[sel] + rw2 % torch.clamp(mult_hi[sel] + 1 - mult_lo[sel], min=1)
            slow_a1 = ((bb + 1) & 0xFF) | (mult << 8)
            skew = skew_lo[sel] + rw1 % torch.clamp(skew_hi[sel] + 1 - skew_lo[sel], min=1)
            a0_sel = a0[rows, sel]
            a1_sel = a1[rows, sel]
            aimed = (m == MODE_NODE) | (m == MODE_PAIR) | (m == MODE_SLOW) | (m == MODE_SKEW)
            new_a0 = torch.where(aimed, aa, a0_sel)
            new_a1 = torch.where(m == MODE_PAIR, bb, torch.where(
                m == MODE_SLOW, slow_a1, torch.where(m == MODE_SKEW, skew, a1_sel)))
            t_add = torch.where(is_fb, t_fb, t_rt1)
            t_ret = torch.where(is_fb, t_fb, t_sel)
            new_t = torch.where(any_add, t_add, torch.where(
                b_ret, t_ret, torch.where(b_time, t_rt1, t_sel)))
            write_t = active & (any_add | b_ret | b_time)
            write_a = active & (any_add | b_ret)
            t[rows, sel] = torch.where(write_t, new_t, t_sel)
            a0[rows, sel] = torch.where(write_a, new_a0, a0_sel)
            a1[rows, sel] = torch.where(write_a, new_a1, a1_sel)
            en[rows, sel] = torch.where(active & any_add, True, torch.where(
                active & b_drop, False, en[rows, sel]))
            cost = torch.where(any_add, 4 + rd, torch.where(
                b_drop, 2, torch.where(b_ret, 2 + rd, torch.where(b_time, 4, 0))))
            j = j + torch.where(active, cost, 0)
        return dict(
            seed=seed,
            time=t,
            kind=cr["kind"][pslot],
            args=torch.stack([a0, a1], dim=-1).to(torch.int32),
            valid=en,
            node=cr["node"][pslot],
            parent=cr["id"][pslot],
        )

    return children


# ---------------------------------------------------------------------------
# stores <-> host state
# ---------------------------------------------------------------------------

_ROW_KEYS = ("time", "kind", "args", "valid", "node")
_ROW_DTYPES = dict(time=_I64, kind=torch.int32, args=torch.int32, valid=torch.bool,
                   node=torch.int32)


def _empty_store(cap1, p, cw, dev):
    """One entry store (corpus or violation) of ``cap1`` rows — the
    last row is scatter trash for refused candidates, never read.
    Seeds and traces are uint64 bit patterns in int64, coverage words
    uint32 in int64 (the port's rule)."""
    z = lambda *shape, dt=_I64: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
    neg = lambda: torch.full((cap1,), -1, dtype=_I64, device=dev)  # noqa: E731
    return dict(
        time=z(cap1, p),
        kind=z(cap1, p, dt=torch.int32),
        args=z(cap1, p, 2, dt=torch.int32),
        valid=z(cap1, p, dt=torch.bool),
        node=z(cap1, p, dt=torch.int32),
        seed=z(cap1),
        trace=z(cap1),
        cov=z(cap1, cw),
        new_bits=z(cap1),
        id=neg(),
        parent=neg(),
        gen=z(cap1),
        viol=z(cap1, dt=torch.bool),
        halt=z(cap1),
        bslot=neg(),
    )


def _u64_as_i64(values) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, np.uint64).view(np.int64).copy())


def _fill_store(store, entries):
    """Load checkpointed CorpusEntry rows into a device store (slot i =
    entries[i], admission order — ids stay whatever the campaign
    assigned)."""
    if not entries:
        return store
    rows = stack_plan_rows([e.plan for e in entries])
    n = len(entries)
    dev = store["seed"].device
    cols = {f: torch.from_numpy(np.asarray(getattr(rows, f))) for f in _ROW_KEYS}
    cols.update(
        seed=_u64_as_i64([e.seed for e in entries]),
        trace=_u64_as_i64([e.trace for e in entries]),
        cov=torch.from_numpy(
            np.stack([np.asarray(e.cov, np.uint32) for e in entries]).astype(np.int64)),
        new_bits=torch.tensor([e.new_bits for e in entries]),
        id=torch.tensor([e.id for e in entries]),
        parent=torch.tensor([e.parent for e in entries]),
        gen=torch.tensor([e.generation for e in entries]),
        viol=torch.tensor([e.violating for e in entries]),
        halt=torch.tensor([e.halt_t for e in entries]),
    )
    for f, v in cols.items():
        store[f][:n] = v.to(device=dev, dtype=store[f].dtype)
    return store


def _store_entry(st_np, i, name) -> CorpusEntry:
    """Materialize store row ``i`` back into a CorpusEntry."""
    events = tuple(
        FaultEvent(
            t=int(st_np["time"][i, p]),
            kind=int(st_np["kind"][i, p]),
            a0=int(st_np["args"][i, p, 0]),
            a1=int(st_np["args"][i, p, 1]),
            node=int(st_np["node"][i, p]),
        )
        for p in range(st_np["time"].shape[1])
    )
    return CorpusEntry(
        id=int(st_np["id"][i]),
        generation=int(st_np["gen"][i]),
        parent=int(st_np["parent"][i]),
        seed=int(st_np["seed"][i].view(np.uint64)),
        plan=LiteralPlan(
            events=events,
            enabled=tuple(bool(x) for x in st_np["valid"][i]),
            name=name,
        ),
        trace=int(st_np["trace"][i].view(np.uint64)),
        cov=np.asarray(st_np["cov"][i]).astype(np.uint32),
        new_bits=int(st_np["new_bits"][i]),
        violating=bool(st_np["viol"][i]),
        halt_t=int(st_np["halt"][i]),
    )


# ---------------------------------------------------------------------------
# the generation-program cache
# ---------------------------------------------------------------------------

# generation-program cache, the engine.search._RUN_CACHE discipline at
# campaign scope: a session of campaigns over fresh root seeds builds
# its sweep, mutator tables and closures once per campaign shape. Keyed
# on (workload identity, config, space hash, batch, build flags,
# invariant identity, seed-corpus literals, mesh, device) — everything
# the built generation closes over. The ROOT SEED is deliberately NOT in
# the key: it enters the programs as a runtime argument. Entries hold
# obs.prof.AotProgram pairs (uniform and breed), so every build is
# timed and retrace-counted (profiler-certified: retraces == 1 per
# key). Bounded LRU; MADSIM_GEN_CACHE_MAX overrides the bound,
# evictions are counted (gen_cache_stats -> flight_summary). Hold ONE
# workload/invariant object across campaigns to hit the cache, exactly
# like engine.search.
_GEN_CACHE: dict = {}
_GEN_CACHE_MAX = 8
_GEN_CACHE_EVICTIONS = 0


def _gen_cache_max() -> int:
    raw = _os.environ.get("MADSIM_GEN_CACHE_MAX")
    if raw is None:
        return _GEN_CACHE_MAX
    try:
        return max(int(raw), 1)
    except ValueError:
        raise ValueError(
            f"MADSIM_GEN_CACHE_MAX={raw!r} is not an integer"
        ) from None


def gen_cache_stats() -> dict:
    """Generation-program cache accounting: live entries, the effective
    bound (``MADSIM_GEN_CACHE_MAX``) and lifetime evictions. A growing
    eviction count in a session means more campaign shapes than cache
    slots, each switch building its generation again; raise the knob."""
    return {
        "entries": len(_GEN_CACHE),
        "max": _gen_cache_max(),
        "evictions": _GEN_CACHE_EVICTIONS,
    }


def _gen_programs(key, make, library, cost, refs):
    """The (uniform, breed) AotProgram pair of a campaign shape: both
    run one ``_Generation`` that ``make()`` returns on the first build;
    ``library`` builds or loads the run kernel's library and ``cost``
    reads its launch shape. ``refs`` (the objects whose identities are
    in ``key``) live as long as the entry, so no id is reused."""
    global _GEN_CACHE_EVICTIONS
    from ..obs.prof import AotProgram

    progs = _GEN_CACHE.get(key)
    if progs is None:
        cap = _gen_cache_max()
        while len(_GEN_CACHE) >= cap:
            _GEN_CACHE.pop(next(iter(_GEN_CACHE)))
            _GEN_CACHE_EVICTIONS += 1
        box: list = []

        def program(breed: bool):
            if not box:
                box.append(make())
            return functools.partial(box[0], breed=breed)

        progs = _GEN_CACHE[key] = (
            AotProgram("explore.device.uniform", (key, "uniform"),
                       lambda: program(False), library=library, cost=cost),
            AotProgram("explore.device.breed", (key, "breed"),
                       lambda: program(True), library=library, cost=cost),
            refs,
        )
    else:
        # LRU touch: re-insertion moves the entry to the back of the
        # eviction order (dicts iterate in insertion order)
        _GEN_CACHE[key] = _GEN_CACHE.pop(key)
    return progs[:2]


def _chunked_any(n: int, width: int, block):
    """``any`` over a (n, width) boolean made ``block(lo, hi)`` rows at a
    time, so a large batch against a large store stays small."""
    step = max(1, (1 << 24) // max(width, 1))
    return torch.cat([block(lo, min(lo + step, n)).any(1) for lo in range(0, n, step)])


class _Generation:
    """One campaign shape's generation, built once: the uniform and the
    breeding children, the sweep, the judge and the admission. Every
    part runs on the campaign's device; ``mark(part)``, when given, is
    called after each part (the timing hook of :func:`run_device`).
    With a ``mesh`` this rank makes, simulates and judges its shard of
    the children (global batch slots ``rank * local ..``); the admission
    inputs are all-gathered, so the admission runs on the whole batch,
    identically on every rank."""

    def __init__(self, wl, cfg, space, *, invariant, batch, max_steps, cov_words,
                 require_halt, select_top, max_corpus, vcap, max_ops, inherit_seed_p,
                 cov_hitcount, metrics, latency, seed_corpus, history_check, causal,
                 retry, dev, mesh=None):
        self.wl, self.space, self.dev, self.mesh = wl, space, dev, mesh
        self.invariant, self.history_check = invariant, history_check
        self.max_corpus, self.vcap = max_corpus, vcap
        n_dev, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
        # this rank's children: global batch slots [lo, lo + batch)
        self.batch = batch // n_dev
        self.lo = rank * self.batch
        self.select_top, self.require_halt = select_top, require_halt
        self.metrics, self.latency = metrics, latency
        self.dup = space.uses_dup()
        tb = {k: host_to_device(torch.as_tensor(v).to(_I64), dev)
              for k, v in mutation_table(space).items()}
        self.mutator = _make_child_mutator(tb, max_ops, inherit_threshold(inherit_seed_p))
        self.sweep = make_sweep(
            wl, cfg, max_steps, device=dev, plan_slots=space.slots, dup_rows=self.dup,
            cov_words=cov_words, metrics=metrics, timeline_cap=0,
            cov_hitcount=cov_hitcount, latency=latency, causal=causal, retry=retry,
        )
        self.k_ov = len(seed_corpus)
        if self.k_ov:
            ov = stack_plan_rows([_pad_literal(lp, space.slots) for lp in seed_corpus])
            self.ov = {f: host_to_device(torch.from_numpy(np.asarray(getattr(ov, f))).to(
                _ROW_DTYPES[f]), dev) for f in _ROW_KEYS}
        self.jglob = self.lo + torch.arange(self.batch, device=dev)

    def keys(self, g: int, rk0, rk1):
        # driver._derive_keys: x0 = generation, x1 = PURPOSE_EXPLORE+slot
        return threefry2x32(rk0, rk1, g & M32, (PURPOSE_EXPLORE + self.jglob) & M32)

    def uniform(self, g: int, rk0, rk1, mark):
        k0s, k1s = self.keys(g, rk0, rk1)
        seeds = _mk_seeds(k0s, k1s)
        mark("mutate")
        rows = self.space.plan.compile_batch(seeds, device=True)
        row_d = {f: getattr(rows, f).to(_ROW_DTYPES[f]) for f in _ROW_KEYS}
        n_ov = min(self.k_ov - self.lo, self.batch)
        if n_ov > 0 and g == 0:
            # the seed-corpus literals replace the first generation-0 rows
            # (those of them in this rank's slots)
            for f in _ROW_KEYS:
                row_d[f] = row_d[f].clone()
                row_d[f][:n_ov] = self.ov[f][self.lo:self.lo + n_ov]
        mark("compile")
        parent = torch.full((self.batch,), -1, dtype=_I64, device=self.dev)
        return dict(seed=seeds, parent=parent, bslot=self.jglob, **row_d)

    def breed(self, cr, g: int, rk0, rk1, mark):
        k0s, k1s = self.keys(g, rk0, rk1)
        fresh = _mk_seeds(k0s, k1s)
        # frontier-first parent order: violating entries before clean
        # ones, newest (largest slot == largest id) first
        cmax1 = self.max_corpus + 1
        slot = torch.arange(cmax1, device=self.dev)
        nv = (~cr["c"]["viol"]).to(_I64)
        key = torch.where(slot < cr["count"], nv * (2 * cmax1) + (cr["count"] - slot),
                          1 << 60)
        order = torch.argsort(key, stable=True)
        # at least 1: a pipelined breed speculated onto an empty corpus
        # runs (and is discarded) without a division by zero
        olen = torch.clamp(cr["count"], min=1, max=self.select_top)
        ch = self.mutator(k0s, k1s, fresh, order, olen, cr["c"])
        mark("mutate")
        mark("compile")
        ch["bslot"] = self.jglob
        return ch

    def judge(self, view):
        seeds = view["seed"]
        if self.invariant is not None:
            ok = torch.as_tensor(self.invariant(view), device=self.dev).to(torch.bool)
            if tuple(ok.shape) != tuple(seeds.shape):
                raise ValueError(
                    f"invariant must return a {tuple(seeds.shape)} boolean "
                    f"tensor, got shape {tuple(ok.shape)}"
                )
        else:
            ok = torch.ones(seeds.shape, dtype=torch.bool, device=self.dev)
        if self.history_check is not None:
            # the device history screen, on the sweep's own history
            # columns: per-seed histories never leave the device
            from ..check.device import screen_ok

            ok = ok & screen_ok(self.history_check, view["hist_word"], view["hist_t"],
                                view["hist_count"], view["hist_drop"])
        if self.require_halt:
            ok = ok & view["halted"]
        over = view["overflow"] > 0
        if self.wl.history is not None:
            over = over | (view["hist_drop"] > 0)
        cols = dict(
            trace=view["trace"],
            halt=view["halt_time"],
            failing=~ok & ~over,
            # overflowed seeds are quarantined from guidance too: their
            # trajectories dropped events, so their bitmaps are artifacts
            cov=torch.where(over[:, None], 0, view["cov"].to(_I64)),
        )
        if self.metrics:
            cols["met"] = view["met"]
        if self.latency is not None:
            cols["lat_hist"] = view["lat_hist"]
        return cols

    def admit(self, cr, g: int, out):
        """Sequential admission over the generation, vectorized: the
        prefix OR gives each child's fresh bits against the map and the
        earlier children; the violation dedup holds each failing child
        against the store and against the earlier failing children of
        the batch; ids, corpus and violation slots are exclusive prefix
        counts. The stores take the winners in place; everything else
        lands in their trash rows."""
        rows, gmap = out["cov"], cr["gmap"]
        inc = prefix_or(rows)
        before = torch.cat([torch.zeros_like(inc[:1]), inc[:-1]]) | gmap
        fresh_bits = popcount32(rows & ~before).sum(1)
        gm2 = gmap | inc[-1]
        seed, trace, fail = out["seed"], out["trace"], out["failing"]
        vs, vt = cr["v"]["seed"], cr["v"]["trace"]
        live = torch.arange(vs.shape[0], device=self.dev) < cr["vcount"]
        b = seed.shape[0]
        idx = torch.arange(b, device=self.dev)
        in_store = _chunked_any(b, vs.shape[0], lambda lo, hi: (
            (seed[lo:hi, None] == vs) & (trace[lo:hi, None] == vt) & live))
        # a violation is counted once per distinct (seed, trace)
        # trajectory (driver seen_viol), within the generation too
        earlier = _chunked_any(b, b, lambda lo, hi: (
            (seed[lo:hi, None] == seed) & (trace[lo:hi, None] == trace) & fail
            & (idx < idx[lo:hi, None])))
        fresh_viol = fail & ~in_store & ~earlier
        qualify = (fresh_bits > 0) | fresh_viol
        q = qualify.to(_I64)
        before_q = torch.cumsum(q, 0) - q
        ids = torch.where(qualify, cr["next_id"] + before_q, -1)
        cnt_j = torch.clamp(cr["count"] + before_q, max=self.max_corpus)
        cslot = torch.where(qualify & (cnt_j < self.max_corpus), cnt_j, -1)
        fv = fresh_viol.to(_I64)
        vc_j = cr["vcount"] + torch.cumsum(fv, 0) - fv
        vslot = torch.where(fresh_viol, torch.clamp(vc_j, max=self.vcap), -1)
        over = cr["over"] | (fresh_viol & (vc_j >= self.vcap)).any()
        gen_col = torch.full((b,), g, dtype=_I64, device=self.dev)
        cols = dict(new_bits=fresh_bits, id=ids, gen=gen_col, viol=fail,
                    **{f: out[f] for f in (*_ROW_KEYS, "seed", "trace", "cov", "parent",
                                           "halt", "bslot")})

        def scatter(store, slots, trash):
            at = (torch.where(slots >= 0, slots, trash),)
            for f, v in cols.items():
                store[f].index_put_(at, v.to(store[f].dtype))

        scatter(cr["c"], cslot, self.max_corpus)
        scatter(cr["v"], vslot, self.vcap)
        nq, admitted = q.sum(), (cslot >= 0).sum()
        cr2 = dict(
            c=cr["c"], v=cr["v"], gmap=gm2,
            count=torch.clamp(cr["count"] + nq, max=self.max_corpus),
            next_id=cr["next_id"] + nq,
            vcount=cr["vcount"] + fv.sum(),
            over=over,
        )
        summary = torch.stack([
            cr2["count"], cr2["next_id"], cr2["vcount"], admitted,
            popcount32(gm2).sum(), over.to(_I64),
        ])
        return cr2, summary

    def __call__(self, cr, g: int, rk0, rk1, breed: bool, mark=None, hook=None):
        mark = mark or (lambda _part: None)
        kids = self.breed(cr, g, rk0, rk1, mark) if breed else self.uniform(g, rk0, rk1, mark)
        view = self.sweep(kids["seed"], PlanRows(**{f: kids[f] for f in _ROW_KEYS}))
        if hook is not None:
            view = hook(g, kids, view)
        mark("sweep")
        out = dict(kids, **self.judge(view))
        mark("judge")
        if self.mesh is not None:
            from ..parallel import gather_rows

            # every rank admits the whole batch, in global slot order
            out = {k: (v if k in ("met", "lat_hist") else gather_rows(v, self.mesh))
                   for k, v in out.items()}
        cr2, summary = self.admit(cr, g, out)
        mark("admit")
        extras = {k: out[k] for k in ("met", "lat_hist") if k in out}
        return cr2, summary, extras


# ---------------------------------------------------------------------------
# the campaign
# ---------------------------------------------------------------------------

_SUMMARY = ("count", "next_id", "vcount", "admitted", "cov_bits", "over")

_STRICT = False
# under counted_syncs: how many generations of each campaign to count
_COUNT: int | None = None


@contextmanager
def strict_syncs():
    """Hold a campaign to one host sync a generation on the card: inside,
    each device campaign's generation loop, from its first dispatch to its
    last consume, runs under ``torch.cuda.set_sync_debug_mode("error")``
    with the consume point's event wait alone exempt, so any other wait
    for the card that torch detects (an ``.item()``, a pageable copy, a
    boolean-mask index, a checkpoint read from the card) raises. Torch
    does not detect every synchronising operation: :func:`counted_syncs`
    counts them. The session's set-up and the final report, which move
    data both ways, lie outside. Without a card it changes nothing."""
    global _STRICT
    prev, _STRICT = _STRICT, True
    try:
        yield
    finally:
        _sync_guard(False)  # a campaign that raised left it on
        _STRICT = prev


@contextmanager
def counted_syncs(generations: int | None = None):
    """Count a device campaign's waits for the card, generation by
    generation. Inside, each counted generation of a campaign on the card
    (its dispatch, its consume point and its checkpoint) runs under
    ``obs.prof.count_syncs``: its telemetry record's ``host_syncs`` is the
    counted number of waits, and anything but the consume point's one
    event wait (one synchronisation, no pageable copy) raises. Every other
    generation records ``host_syncs: None``: not counted. ``generations``
    counts only the first that many generations of each campaign (default
    every one). The profiler's own end waits for the card, so a counted
    generation is not a pipelined one: count a campaign, do not time it.
    It nests with :func:`strict_syncs`."""
    global _COUNT
    prev, _COUNT = _COUNT, (1 << 62) if generations is None else generations
    try:
        yield
    finally:
        _COUNT = prev


def _sync_guard(on: bool) -> None:
    if _STRICT and torch.cuda.is_available():
        torch.cuda.set_sync_debug_mode("error" if on else "default")


class _GenerationSyncs:
    """The host syncs of one generation: counted by the profiler when
    ``counting`` (:meth:`count` wraps the generation's dispatch, consume
    point and checkpoint), else not counted (``host_syncs`` None)."""

    def __init__(self, g: int, counting: bool):
        self.g, self.counting = g, counting
        self.counted = None

    @contextmanager
    def count(self):
        if not self.counting:
            yield
            return
        from ..obs.prof import count_syncs

        with count_syncs() as sc:
            try:
                yield
            finally:
                _sync_guard(False)  # the profiler's own end waits for the card
        _sync_guard(True)
        self.counted = sc
        if sc.syncs != 1 or sc.pageable:
            raise RuntimeError(
                f"counted_syncs: generation {self.g} waited for the card "
                f"{sc.syncs} time(s) and made {sc.pageable} pageable copies "
                f"({sc.names}); the consume point's one event wait is the only "
                f"one allowed"
            )

    @property
    def host_syncs(self) -> int | None:
        return self.counted.total if self.counted is not None else None


def _counted_total(counted: list) -> int | None:
    """A campaign's counted waits for the card: the sum of its
    generations' ``host_syncs`` if every one was counted, else None."""
    return None if None in counted else sum(counted)


class _HostCopy:
    """A dispatched generation's host view: its admission summary, its
    fleet totals and, when the campaign checkpoints, what the checkpoint
    reads (:meth:`_CampaignSession.stage`), copied to pinned host buffers
    behind the generation's work on the card, with the event the consume
    point waits on. On one CUDA stream a plain ``.tolist()`` or ``.cpu()``
    of generation g would also wait for g+1, already queued behind it;
    these copies wait for nothing. On the CPU the values are final when
    the dispatch returns."""

    def __init__(self, summary, totals: dict, staged: dict | None = None):
        cuda = summary.is_cuda

        def host(t):
            if isinstance(t, dict):
                return {k: host(v) for k, v in t.items()}
            if not cuda:
                return t
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            out.copy_(t, non_blocking=True)
            return out

        self.summary = host(summary)
        self.totals = host(totals)
        self.staged = host(staged) if staged is not None else None
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        """THE consume-point sync: the generation and its copies are done."""
        if self.event is not None:
            _sync_guard(False)
            self.event.synchronize()
            _sync_guard(True)


class _CampaignSession:
    """Everything a device campaign threads between generations:
    argument validation, checkpoint resume, the device carry, the
    cached generation programs, host mirrors, telemetry and report
    assembly — shared by the blocking driver (:func:`run_device`) and
    the pipelined one (``farm.run_pipelined``)."""

    def __init__(
        self, wl, cfg, space, *, invariant, generations, batch, root_seed,
        max_steps, cov_words, layout, require_halt, seed_corpus, select_top,
        max_corpus, max_ops, inherit_seed_p, log, cov_hitcount, telemetry,
        resume, checkpoint_path, latency, metrics, mesh, viol_cap,
        pool_index, history_check, causal=False, device=None,
    ):
        del layout, pool_index  # one lowering of the step: no effect
        if isinstance(space, FaultPlan):
            space = PlanSpace(space)
        if history_check is not None:
            from ..check.device import as_screens

            history_check = as_screens(history_check)
            if wl.history is None:
                raise ValueError(
                    f"history_check judges operation histories, but workload "
                    f"{wl.name!r} has Workload.history=None"
                )
        if invariant is None and history_check is None:
            raise ValueError(
                "run_device needs a traceable final-state invariant and/or a "
                "history_check screen set (both run on the sweep's device, "
                "over its tensors); arbitrary host-side history_invariant "
                "callables need the host driver — use explore.run for those hunts"
            )
        if cov_words < 1:
            raise ValueError(
                "exploration needs cov_words >= 1 (the guidance)"
            )
        if generations < 1 or batch < 1:
            raise ValueError("need generations >= 1 and batch >= 1")
        if len(seed_corpus) > batch:
            raise ValueError(
                f"{len(seed_corpus)} seed-corpus plans exceed batch={batch}"
            )
        n_dev = mesh.size if mesh is not None else 1
        if batch % n_dev:
            raise ValueError(
                f"batch={batch} does not split over {n_dev} mesh devices"
            )
        vcap = int(viol_cap) if viol_cap is not None else int(max_corpus)
        # derive the engine retry build flag from the space plan's
        # ClientArmy policy (the host driver's rule; LiteralPlan spaces
        # have no retry_spec and run fire-and-forget)
        retry = (
            space.plan.retry_spec() if hasattr(space.plan, "retry_spec")
            else None
        )
        dev = mesh.device if mesh is not None else resolve_device(device)
        p_slots = space.slots
        cmax1 = int(max_corpus) + 1
        vcap1 = vcap + 1

        # the host-side validations the host driver gets from
        # search_seeds: plan targets and user kinds against the workload
        space.plan.compile_batch(np.zeros(1, np.uint64), wl=wl)

        # ---- resumed / fresh host mirrors ----
        loaded_corpus: list = []
        loaded_viol: list = []
        if resume is not None:
            from .persist import resolve_resume

            st = resolve_resume(resume, wl, space, cfg, root_seed, batch,
                                cov_words, cov_hitcount)
            if len(st.corpus) > max_corpus:
                raise ValueError(
                    f"checkpoint carries {len(st.corpus)} corpus entries; "
                    f"max_corpus={max_corpus} cannot hold them"
                )
            if len(st.violations) > vcap:
                raise ValueError(
                    f"checkpoint carries {len(st.violations)} violations; "
                    f"raise viol_cap (now {vcap})"
                )
            loaded_corpus = list(st.corpus)
            loaded_viol = list(st.violations)
            gmap0 = np.asarray(st.cov_map, np.uint32)
            self.curve = list(st.curve)
            self.viol_curve = list(st.viol_curve)
            next_id0 = st.next_id
            self.sims = st.sims
            self.g_start = st.generations_done
        else:
            gmap0 = np.zeros((cov_words,), np.uint32)
            self.curve = []
            self.viol_curve = []
            next_id0 = 0
            self.sims = 0
            self.g_start = 0

        scalar = lambda v: torch.tensor(v, dtype=_I64, device=dev)  # noqa: E731
        self.carry = dict(
            c=_fill_store(_empty_store(cmax1, p_slots, cov_words, dev), loaded_corpus),
            v=_fill_store(_empty_store(vcap1, p_slots, cov_words, dev), loaded_viol),
            gmap=torch.from_numpy(gmap0.astype(np.int64)).to(dev),
            count=scalar(len(loaded_corpus)),
            next_id=scalar(next_id0),
            vcount=scalar(len(loaded_viol)),
            over=torch.tensor(False, device=dev),
        )
        self.count = len(loaded_corpus)  # host mirror (uniform vs breed)

        # materialized-entry caches: slot -> CorpusEntry. Loaded entries
        # are returned as the same objects (names and identity survive
        # resume); new slots materialize once and are reused by every
        # later checkpoint/report build.
        self._c_cache = {i: e for i, e in enumerate(loaded_corpus)}
        self._v_cache = {i: e for i, e in enumerate(loaded_viol)}

        # ---- the generation (built once per cache key) ----
        key = (
            id(wl), id(invariant), cfg.hash(), space.hash(), batch,
            max_steps, cov_words, require_halt, select_top,
            int(max_corpus), vcap, max_ops, float(inherit_seed_p),
            bool(cov_hitcount), bool(metrics), latency,
            tuple(lp.hash() for lp in seed_corpus), bool(causal), retry,
            # screens are value-hashable literals, so equal screen sets
            # share a generation across campaigns
            history_check, str(dev),
            (mesh.size, mesh.rank) if mesh is not None else None,
        )
        taps = dict(cov_words=cov_words, cov_hitcount=bool(cov_hitcount), causal=bool(causal))
        self.prog_uniform, self.prog_breed = _gen_programs(
            key,
            lambda: _Generation(
                wl, cfg, space, invariant=invariant, batch=batch, max_steps=max_steps,
                cov_words=cov_words, require_halt=require_halt, select_top=select_top,
                max_corpus=int(max_corpus), vcap=vcap, max_ops=max_ops,
                inherit_seed_p=inherit_seed_p, cov_hitcount=cov_hitcount,
                metrics=metrics, latency=latency, seed_corpus=seed_corpus,
                history_check=history_check, causal=causal, retry=retry, dev=dev,
                mesh=mesh,
            ),
            lambda: _library_build_s(wl, dev, space.uses_dup(), cfg.pool_size, taps),
            lambda: launch_cost(wl, cfg, dev, space.uses_dup(), taps),
            (wl, invariant, latency, space),
        )

        self.wl = wl
        self.cfg = cfg
        self.space = space
        self.dev = dev
        self.mesh = mesh
        self.n_dev = n_dev
        self.generations = generations
        self.batch = batch
        self.root_seed = int(root_seed)
        self.max_steps = max_steps
        self.cov_words = cov_words
        self.cov_hitcount = cov_hitcount
        self.log = log
        self.telemetry = telemetry
        self.checkpoint_path = checkpoint_path
        self.vcap = vcap
        self.max_corpus = int(max_corpus)
        self.seed_corpus = seed_corpus
        self.k_ov = len(seed_corpus)
        self.next_id = next_id0  # host mirror for snapshots
        self.vcount_host = len(loaded_viol)
        self.log_label = "device"
        # the campaign root key enters the generation as a RUNTIME
        # argument (same threefry coordinates as driver._derive_keys),
        # so one built generation serves every root seed
        self.rk0 = scalar(self.root_seed & M32)
        self.rk1 = scalar((self.root_seed >> 32) & M32)

    # ---- scheduling primitives -----------------------------------------
    def runner(self, breed: bool):
        return self.prog_breed if breed else self.prog_uniform

    def fleet_totals(self, extras) -> dict:
        """A generation's tap columns folded into fleet totals on the
        device (summed over the mesh's ranks too): tensors, so that a
        pipelined dispatch can copy them to the host without a wait."""
        from .. import parallel as _par

        out = {}
        if "met" in extras:
            out["met_total"] = _par.fold_rows(extras["met"], self.mesh)
        if "lat_hist" in extras:
            out["lat_total_ops"] = _par.fold_rows(extras["lat_hist"], self.mesh).sum()
        return out

    def stage(self, before, after) -> dict | None:
        """What the checkpoint after the generation that took carry
        ``before`` to ``after`` reads, as device tensors for
        :class:`_HostCopy`: the coverage map, the stores' counts before
        the generation and ``batch`` rows of each store from there (a
        generation admits at most ``batch`` rows, at consecutive slots
        from the count). None when this rank writes no checkpoint."""
        if self.checkpoint_path is None or (self.mesh is not None and self.mesh.rank != 0):
            return None
        span = torch.arange(self.batch, device=self.dev)

        def rows(store, n0, cap):
            at = torch.clamp(n0 + span, max=cap)
            return {f: v.index_select(0, at) for f, v in store.items()}

        return dict(gmap=after["gmap"], c0=before["count"], v0=before["vcount"],
                    c=rows(after["c"], before["count"], self.max_corpus),
                    v=rows(after["v"], before["vcount"], self.vcap))

    def host_copy(self, before, after, summary, extras) -> _HostCopy:
        """Queue generation's host view behind it (:class:`_HostCopy`)."""
        return _HostCopy(summary, self.fleet_totals(extras), self.stage(before, after))

    @staticmethod
    def fleet(totals) -> dict:
        """The telemetry form of :meth:`fleet_totals` (host values)."""
        fleet: dict = {}
        if "met_total" in totals:
            fleet["met_total"] = [int(x) for x in totals["met_total"].tolist()]
        if "lat_total_ops" in totals:
            fleet["lat_total_ops"] = int(totals["lat_total_ops"])
        return fleet

    def consume(self, g: int, s, fleet: dict, walls: dict, copy: _HostCopy) -> dict:
        """Fold generation ``g``'s admission summary into the host
        mirrors: curve/corpus-count/violation bookkeeping, the log line,
        and the per-generation checkpoint, read from the generation's
        host ``copy`` alone. Returns the generation telemetry record
        (``walls`` carries the driver's wall split) for
        :meth:`emit_generation`, which adds its ``host_syncs``."""
        if bool(s["over"]):
            raise RuntimeError(
                f"device violation store overflowed (viol_cap={self.vcap}) "
                f"at generation {g}: the (seed, trace) dedup can no longer "
                f"match the host driver — raise viol_cap"
            )
        self.sims += self.batch
        self.count = int(s["count"])
        self.next_id = int(s["next_id"])
        new_viol = int(s["vcount"]) - self.vcount_host
        self.vcount_host = int(s["vcount"])
        self.curve.append(int(s["cov_bits"]))
        self.viol_curve.append(self.vcount_host)
        if self.log is not None:
            self.log(
                f"explore[{self.log_label}] g{g}: {self.curve[-1]} "
                f"coverage bits (+{int(s['admitted'])} corpus entries, "
                f"corpus {self.count}), {self.vcount_host} violations"
            )
        if self.checkpoint_path is not None and (self.mesh is None or self.mesh.rank == 0):
            # one writer: every rank holds the same campaign
            self.snapshot(g + 1, s, copy).save(self.checkpoint_path)
        return {
            "event": "generation", "generation": g, "sims": self.sims,
            "cov_bits": self.curve[-1], "new_entries": int(s["admitted"]),
            "corpus_size": self.count, "violations": self.vcount_host,
            # host_syncs: filled by emit_generation, in the schema's place
            "new_violations": new_viol, **walls, "host_syncs": None, **fleet,
        }

    def generation_syncs(self, g: int) -> _GenerationSyncs:
        """Generation ``g``'s sync count: counted under
        :func:`counted_syncs` if the campaign runs on the card and ``g``
        is among the first generations it counts."""
        counting = (_COUNT is not None and g - self.g_start < _COUNT
                    and self.dev.type == "cuda")
        return _GenerationSyncs(g, counting)

    def emit_generation(self, record: dict, syncs: _GenerationSyncs) -> None:
        """Emit a generation's record with its ``host_syncs``: the
        counted number, or None where it was not counted."""
        record["host_syncs"] = syncs.host_syncs
        self.emit(record)

    # ---- materialization ------------------------------------------------
    def _entry_name(self, gen, parent, bslot, seed):
        if parent >= 0:
            return f"g{gen}p{parent}"
        if gen == 0 and 0 <= bslot < self.k_ov:
            return self.seed_corpus[bslot].name
        return f"{self.space.plan.name}@{seed}"

    def _materialize(self, n_c: int, n_v: int, gmap, read):
        """The first ``n_c`` corpus and ``n_v`` violation entries and the
        coverage map on the host; ``read(store, lo, hi)`` gives a store's
        rows ``lo..hi`` as numpy columns."""
        c_cache, v_cache = self._c_cache, self._v_cache

        # only the rows not materialized yet cross to the host
        c_lo = len(c_cache)
        cn = read("c", c_lo, n_c)
        for i in range(c_lo, n_c):
            k = i - c_lo
            c_cache[i] = _store_entry(
                cn, k,
                self._entry_name(int(cn["gen"][k]), int(cn["parent"][k]),
                                 int(cn["bslot"][k]),
                                 int(cn["seed"][k].view(np.uint64))),
            )
        corpus = [c_cache[i] for i in range(n_c)]
        by_id = {e.id: e for e in corpus}
        v_lo, v_hi = len(v_cache), min(n_v, self.vcap)
        vn = read("v", v_lo, v_hi)
        for i in range(v_lo, v_hi):
            k = i - v_lo
            eid = int(vn["id"][k])
            # a violating entry that also joined the corpus is the SAME
            # object in both lists (the host driver's sharing)
            v_cache[i] = by_id.get(eid) or _store_entry(
                vn, k,
                self._entry_name(int(vn["gen"][k]), int(vn["parent"][k]),
                                 int(vn["bslot"][k]),
                                 int(vn["seed"][k].view(np.uint64))),
            )
        violations = [v_cache[i] for i in range(v_hi)]
        return corpus, violations, np.asarray(gmap).astype(np.uint32)

    def snapshot(self, gens_done: int, s, copy: _HostCopy):
        """The campaign after the generation of summary ``s``, from that
        generation's host ``copy``: nothing here waits for the card."""
        from .persist import CampaignState

        st = copy.staged

        def read(store, lo, hi):
            base = int(st[store + "0"])
            if lo < base:
                raise RuntimeError(
                    f"checkpoint needs {store!r} rows from {lo}, but the "
                    f"generation staged them from {base}"
                )
            return {k: v[lo - base:hi - base].numpy() for k, v in st[store].items()}

        corpus, violations, gm = self._materialize(
            int(s["count"]), int(s["vcount"]), st["gmap"].numpy(), read)
        return CampaignState(
            workload=self.wl.name, config_hash=self.cfg.hash(),
            plan_hash=self.space.hash(), root_seed=self.root_seed,
            batch=self.batch, cov_words=self.cov_words,
            cov_hitcount=self.cov_hitcount, generations_done=gens_done,
            next_id=self.next_id, sims=self.sims, curve=list(self.curve),
            viol_curve=list(self.viol_curve), cov_map=gm.copy(),
            corpus=list(corpus), violations=list(violations),
        )

    # ---- telemetry + report ---------------------------------------------
    def emit(self, record: dict) -> None:
        if self.telemetry is not None:
            self.telemetry(record)

    def start(self, driver: str, **extra) -> None:
        """The campaign_start record; the generation loop follows (under
        :func:`strict_syncs`, the sync guard goes on here)."""
        self.emit({
            "event": "campaign_start", "workload": self.wl.name,
            "config_hash": self.cfg.hash(), "plan_hash": self.space.hash(),
            "root_seed": self.root_seed, "batch": self.batch,
            "generations": self.generations, "cov_words": self.cov_words,
            "cov_hitcount": self.cov_hitcount,
            "resumed_at_generation": self.g_start,
            "driver": driver, "mesh_devices": self.n_dev, **extra,
        })
        _sync_guard(True)

    def report(self, *, wall_dispatch, wall_sync, wall_compile, host_syncs,
               wall_queue=0.0, wall_idle=0.0) -> ExploreReport:
        _sync_guard(False)
        carry = self.carry
        corpus, violations, gm = self._materialize(
            int(carry["count"]), int(carry["vcount"]), carry["gmap"].cpu().numpy(),
            lambda store, lo, hi: {k: v[lo:hi].cpu().numpy()
                                   for k, v in carry[store].items()})
        return ExploreReport(
            workload=self.wl.name,
            config_hash=self.cfg.hash(),
            plan_hash=self.space.hash(),
            root_seed=self.root_seed,
            generations=self.g_start + self.generations,
            batch=self.batch,
            max_steps=self.max_steps,
            cov_words=self.cov_words,
            sims=self.sims,
            corpus=corpus,
            violations=violations,
            cov_map=gm,
            curve=self.curve,
            viol_curve=self.viol_curve,
            next_id=self.next_id,
            cov_hitcount=self.cov_hitcount,
            wall_dispatch_s=wall_dispatch,
            wall_host_s=wall_sync,
            wall_compile_s=wall_compile,
            host_syncs=host_syncs,
            wall_gens=self.generations,
            wall_queue_s=wall_queue,
            wall_idle_s=wall_idle,
        )


class _PartClock:
    """Times the parts of one generation without a sync of its own: CUDA
    events on the card, read after the generation's one summary sync;
    the host clock on the CPU, where every op has finished on return."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"
        self.marks = []
        self.mark("start")

    def mark(self, part: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((part, ev))
        else:
            self.marks.append((part, _time.perf_counter()))  # lint: allow(wall-clock)

    def parts_ms(self) -> dict:
        out = dict.fromkeys(PARTS, 0.0)
        for (_p0, a), (p1, b) in zip(self.marks, self.marks[1:]):
            out[p1] += a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return {k: round(v, 3) for k, v in out.items()}


def run_device(
    wl,
    cfg,
    space,
    *,
    invariant,
    generations: int = 8,
    batch: int = 256,
    root_seed: int = 0,
    max_steps: int = 1000,
    cov_words: int = 32,
    layout: str | None = None,
    require_halt: bool = False,
    seed_corpus=(),
    select_top: int = 32,
    max_corpus: int = 4096,
    max_ops: int = 3,
    inherit_seed_p: float = 0.75,
    log=None,
    cov_hitcount: bool = False,
    telemetry=None,
    resume=None,
    checkpoint_path: str | None = None,
    latency=None,
    metrics: bool = False,
    mesh=None,
    viol_cap: int | None = None,
    pool_index: bool | None = None,
    history_check=None,
    causal: bool = False,
    device=None,
    sweep_hook=None,
) -> ExploreReport:
    """Run one exploration campaign with every generation device-resident.

    Same contract and bit-identical outcomes as :func:`explore.run`
    (module docstring), with these differences:

    * ``invariant`` must be a predicate over the final state's tensor
      view (``{field: tensor} -> (S,) bool``) — it runs on the sweep's
      device. ``history_check`` (a ``check.device.HistoryScreen`` or
      tuple) is the device form of a ``history_invariant`` hunt: the
      batch detectors run on the sweep's history columns and their
      verdicts mark violations exactly like the host driver running
      ``check.device.screens_invariant(history_check)`` — the two
      campaigns are bit-identical, and a device find replays/shrinks
      on the host driver through that same invariant. At least one of
      the two must be given; arbitrary host-side ``history_invariant``
      callables still need the host driver.
    * ``mesh`` (a ``parallel.make_mesh`` value over a
      ``torch.distributed`` world) shards every generation's children
      over the ranks: each rank simulates ``batch / world size`` of them
      on its own device and the admission inputs are all-gathered, so
      every rank returns the unsharded campaign's report (``batch`` must
      split over the world; one rank writes the checkpoint).
      ``layout`` and ``pool_index`` change nothing (one lowering).
    * ``metrics=True`` folds per-generation fleet-metric totals into the
      telemetry records (``parallel.merge_metrics``); ``latency``
      likewise folds the fleet's completed ops via
      ``parallel.merge_latency``. Both are derived state: campaign
      outcomes are unchanged.
    * ``causal=True`` runs the generations with the engine's causal
      columns on (``explore.run`` docstring): the causal-depth/width
      coverage feature class joins the guidance.
    * ``viol_cap`` bounds the device violation store (default
      ``max_corpus``); a campaign that finds more raises instead of
      silently breaking the (seed, trace) dedup.
    * ``checkpoint_path`` materializes the corpus to the host after
      every generation (that is what a checkpoint IS): each generation
      also copies the coverage map and ``batch`` rows of each store to
      pinned host memory behind its work — set it only when
      resumability is worth the extra transfer.
    * ``device`` is where the campaign runs: the card unless the caller
      asks for the CPU.
    * ``sweep_hook`` (default None: the campaign as it is) is called as
      ``sweep_hook(g, children, view)`` after each generation's sweep,
      with this rank's children (seeds and plan rows) and the final
      state's tensor view, and returns the view the judge and the
      admission read: the seam of ``lint.check_campaign``, which records
      a generation's children and perturbs derived columns there.

    The per-generation host sync transfers only the admission summary;
    telemetry records carry the dispatch/compile/sync wall split,
    ``host_syncs`` (under :func:`counted_syncs` the profiler's count of
    the generation's waits for the card, else None: not counted) and
    ``parts_ms`` (the device ms of the
    generation's parts: mutate, compile, sweep, judge, admit; CUDA
    events on the card, read after the sync), so the claim is checkable
    from the artifact. ``compile_wall_s`` is the build share of that
    generation (``obs.prof.AotProgram``: the generation program's build
    and the kernel library's build or load): nonzero only when the
    campaign shape's program is built, 0.0 on a warm cache.
    """
    sess = _CampaignSession(
        wl, cfg, space, invariant=invariant, generations=generations,
        batch=batch, root_seed=root_seed, max_steps=max_steps,
        cov_words=cov_words, layout=layout, require_halt=require_halt,
        seed_corpus=seed_corpus, select_top=select_top,
        max_corpus=max_corpus, max_ops=max_ops,
        inherit_seed_p=inherit_seed_p, log=log, cov_hitcount=cov_hitcount,
        telemetry=telemetry, resume=resume,
        checkpoint_path=checkpoint_path, latency=latency, metrics=metrics,
        mesh=mesh, viol_cap=viol_cap, pool_index=pool_index,
        history_check=history_check, causal=causal, device=device,
    )
    sess.start("device")

    wall_dispatch = 0.0
    wall_sync = 0.0
    wall_compile = 0.0
    host_syncs = 0  # consume points, one a generation
    counted = []  # the counted generations' host_syncs

    for g in range(sess.g_start, sess.g_start + generations):
        syncs = sess.generation_syncs(g)
        with syncs.count():
            t0 = _time.monotonic()  # lint: allow(wall-clock)
            breed = g > 0 and sess.count > 0
            runner = sess.runner(breed)
            # the build share of this generation (0.0 on a warm cache),
            # split out of dispatch so warm-vs-cold comparisons compare
            # like with like; built before the part clock starts
            runner.build()
            clock = _PartClock(sess.dev)
            before = sess.carry
            sess.carry, summary, extras = runner(
                before, g, sess.rk0, sess.rk1, mark=clock.mark, hook=sweep_hook
            )
            copy = sess.host_copy(before, sess.carry, summary, extras)
            t1 = _time.monotonic()  # lint: allow(wall-clock)
            compile_wall = runner.last_build_s
            # THE host sync: the admission summary, the fleet totals and
            # what a checkpoint reads — per-seed state stays on the device
            copy.wait()
            host_syncs += 1
            s = dict(zip(_SUMMARY, copy.summary.tolist()))
            fleet = sess.fleet(copy.totals)
            t2 = _time.monotonic()  # lint: allow(wall-clock)
            wall_dispatch += (t1 - t0) - compile_wall
            wall_sync += t2 - t1
            wall_compile += compile_wall
            record = sess.consume(g, s, fleet, {
                "dispatch_wall_s": round((t1 - t0) - compile_wall, 3),
                "compile_wall_s": round(compile_wall, 3),
                "sync_wall_s": round(t2 - t1, 3),
                # the pipeline wall split, zero by construction on the
                # blocking schedule (the driver never enqueues ahead)
                "queue_wall_s": 0.0,
                "idle_wall_s": 0.0,
                "parts_ms": clock.parts_ms(),
            }, copy)
        sess.emit_generation(record, syncs)
        counted.append(syncs.host_syncs)

    sess.emit({
        "event": "campaign_end", "generations": sess.g_start + generations,
        "generations_run": generations,
        "sims": sess.sims,
        "cov_bits": sess.curve[-1] if sess.curve else 0,
        "corpus_size": sess.count, "violations": sess.vcount_host,
        "wall_dispatch_s": round(wall_dispatch, 3),
        "wall_sync_s": round(wall_sync, 3),
        "wall_compile_s": round(wall_compile, 3),
        "wall_queue_s": 0.0,
        "wall_idle_s": 0.0,
        "host_syncs": _counted_total(counted),
    })
    return sess.report(
        wall_dispatch=wall_dispatch, wall_sync=wall_sync,
        wall_compile=wall_compile, host_syncs=host_syncs,
    )
