"""Causal provenance in the torch port, against the JAX package.

* **The fold.** ``causal=True`` runs of the port's plain step equal the
  JAX engine's (scatter layout, int64 times) per field, the six causal
  columns and the tag-7 coverage bits and hit counts included: kvchaos
  ``bug=True`` without its own chaos under the causal soak's crash
  storm with every tap, raft-record under a crash plan (``PARENT_PLAN``
  rows), kvchaos's client army (``PARENT_ARMY`` rows), kvchaos-bug under
  the soak's Duplicate and GrayFailure plan (shadow rows, slowed links)
  and the soak's 16-write diskless raftlog-record under its hunt plan.
* **Derived state.** With the axis off the columns are zero-size and
  every other field is the axis-on run's; the step goldens' army
  scenarios with ``causal=True`` still digest to ``GOLDENS`` and their
  causal columns are the JAX package's.
* **Runners.** ``search_seeds(causal=True)`` (lockstep and compacted,
  with ``device_check``) and ``make_run_compacted(causal=True)`` bank the
  JAX package's columns; checkpoints carry them; a causal-off state is
  refused by a causal step; ``check_determinism`` compares them.
* **Lineage.** ``obs.causal`` on port captures: ``rederive`` equals the
  captured clocks, seqs strictly increase, cones are closed, the three
  anchor forms agree, and the JAX package's pinned pingpong cone.
  ``check.device.violation_cones`` gives one cone per flagged seed.
* **Fleet shape.** ``obs.fleet_reduce`` with and without ``lam`` equals
  the JAX package's, field by field and as text.
* **The kernel.** The run kernel's step code built with g++ (the
  ``kvchaos-bug-nochaos`` library with the taps, and its ``-dup``
  sibling) equals the plain step with the axis on.

Exact equality throughout: the engine is integer arithmetic.
"""

import _torch_threads  # noqa: F401
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

import madsim_tpu.chaos as jc
import madsim_tpu.engine as je
import madsim_tpu.models as jm
import madsim_tpu.obs as jobs
from madsim_tpu.check import device as jdc
from madsim_tpu.engine.compact import make_run_compacted as j_compacted
from madsim_tpu_torch import chaos as tc
from madsim_tpu_torch import models as tm
from madsim_tpu_torch import obs as tobs
from madsim_tpu_torch.check import device as tdc
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.checkpoint import load, save
from madsim_tpu_torch.engine.compact import RESULT_FIELDS, make_run_compacted
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.engine.search import search_seeds
from madsim_tpu_torch.engine.verify import DERIVED_FIELDS, check_determinism
from madsim_tpu_torch.obs.causal import causal_slice, derive_parents, parent_class, rederive

from _torch_causal import (
    HUNT_KW, KV_KW, arrow_plan, capture_both, hunt_plan, kv_plan, seeds_of,
)
from _torch_host import build_host_kernel, host_run
from _torch_parity import assert_same_state

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

import step_goldens  # noqa: E402

from _step_goldens import GOLDENS  # noqa: E402
from test_torch_goldens import jax_order, port_scenarios  # noqa: E402

CAUSAL = tcore.CAUSAL_STATE_FIELDS
KV_TAPS = dict(metrics=True, timeline_cap=128, cov_words=64, cov_hitcount=True, causal=True)
KV_STEPS = 4000
RAFT_KW = dict(pool_size=64, loss_p=0.02)
RAFT_STEPS = 600


def raft_plan(m):
    return m.FaultPlan((m.CrashStorm(targets=(1, 2, 3), n=1),), name="causal-test")


def kv_bug(m):
    return m.make_kvchaos(writes=10, record=True, bug=True, chaos=False)


@pytest.fixture(scope="module")
def kv_runs():
    """kvchaos-bug under the soak's crash storm with every tap and the
    causal axis, in both packages (every field asserted equal)."""
    seeds = seeds_of(8, 37)
    jo, to = capture_both(kv_bug(jm), kv_bug(tm), kv_plan(jc), kv_plan(tc), KV_KW, seeds,
                          KV_STEPS, **KV_TAPS)
    return seeds, jo, to


def test_kvchaos_bug_under_the_crash_storm_equals_the_reference(kv_runs):
    """The fold, the sidecars, the ring's causal columns and the tag-7
    features land exactly where the JAX engine puts them."""
    seeds, _jo, to = kv_runs
    assert to.lam.shape == (len(seeds), 6) and int(to.lam.max()) > 10
    assert (to.tl_seq[:, 1:] > to.tl_seq[:, :1]).any()
    # the causal features are coverage: the axis-off bitmap lacks them
    off = tcore.make_run_while(kv_bug(tm), tcore.EngineConfig(**KV_KW), KV_STEPS,
                               **{**KV_TAPS, "causal": False})(
        tcore.make_init(kv_bug(tm), tcore.EngineConfig(**KV_KW), device="cpu",
                        plan_slots=kv_plan(tc).slots, **{**KV_TAPS, "causal": False})(
            seeds, kv_plan(tc).compile_batch(seeds, wl=kv_bug(tm))))
    assert not to.cov.equal(off.cov) and not to.cov_hits.equal(off.cov_hits)
    for f in tcore.STATE_FIELDS:
        if f in CAUSAL or f in ("cov", "cov_hits"):
            continue
        assert getattr(to, f).equal(getattr(off, f)), f
    for f in CAUSAL:
        assert getattr(off, f).numel() == 0, f


def test_raft_record_plan_rows_are_plan_parented():
    seeds = seeds_of(8)
    _jo, to = capture_both(jm.make_raft(record=True), tm.make_raft(record=True), raft_plan(jc),
                           raft_plan(tc), RAFT_KW, seeds, RAFT_STEPS, timeline_cap=256,
                           causal=True)
    classes = {parent_class(e.parent) for s in range(len(seeds))
               for e in tobs.decode_timeline(to, None, s)}
    assert {"plan", "init", "event"} <= classes


def test_client_army_rows_are_army_parented():
    mk = dict(writes=12, n_replicas=2, chaos=False, army=True, army_probes=3)
    army = dict(n_ops=16, n_replicas=2, t_min_ns=5_000_000, t_max_ns=300_000_000)
    jplan = jc.FaultPlan((jm.kvchaos.client_army(**army),))
    tplan = tc.FaultPlan((tm.kvchaos.client_army(**army),))
    seeds = seeds_of(6, 104729)
    init = tcore.make_init(tm.make_kvchaos(**mk), tcore.EngineConfig(pool_size=160),
                           device="cpu", plan_slots=tplan.slots, causal=True)(
        seeds, tplan.compile_batch(seeds, wl=tm.make_kvchaos(**mk)))
    assert (init.ev_parent == tcore.PARENT_ARMY).any()
    _jo, to = capture_both(jm.make_kvchaos(**mk), tm.make_kvchaos(**mk), jplan, tplan,
                           dict(pool_size=160, loss_p=0.02), seeds, 3000, timeline_cap=256,
                           causal=True)
    classes = {parent_class(e.parent) for s in range(len(seeds))
               for e in tobs.decode_timeline(to, None, s)}
    assert "army" in classes


@pytest.fixture(scope="module")
def arrow_runs():
    """kvchaos-bug under the soak's arrow confuser (shadow rows and
    slowed links), both packages, a 512-row causal ring."""
    seeds = seeds_of(4) + np.uint64(77)
    return capture_both(kv_bug(jm), kv_bug(tm), arrow_plan(jc), arrow_plan(tc), KV_KW, seeds,
                        KV_STEPS, metrics=True, timeline_cap=512, causal=True)


def test_dup_shadow_rows_take_the_dispatch_seq(arrow_runs):
    _jo, to = arrow_runs
    assert int(to.met[:, tcore.MET_DUP].sum()) > 0
    for s in range(to.seed.shape[0]):
        ev = tobs.decode_timeline(to, None, s)
        assert rederive(ev) == [e.lam for e in ev]


def test_sixteen_write_raftlog_under_the_hunt_plan():
    mk = dict(record=True, chaos=False, durable=False, n_writes=16)
    _jo, to = capture_both(jm.make_raftlog(**mk), tm.make_raftlog(**mk), hunt_plan(jc),
                           hunt_plan(tc), HUNT_KW, seeds_of(3, 137), 3000, timeline_cap=512,
                           causal=True)
    assert int(to.hist_count.min()) > 0 and int(to.tl_count.min()) > 0
    assert fused.kernel_model(tm.make_raftlog(**mk)).key == "raftlog-record-w16-nochaos"


def test_the_army_goldens_with_the_axis_on():
    """The step goldens' army scenarios run with causal=True: the digest
    drops the causal columns by name, but with coverage on the tag-7
    features change the bitmap and the hit counters, so the digest is
    the JAX package's causal=True digest and not GOLDENS; every field but
    those two (and the causal columns) is the causal-off run's, which
    digests to GOLDENS, and the causal columns are the JAX package's."""
    want = step_goldens.scenarios()
    seeds = np.arange(step_goldens.N_SEEDS, dtype=np.uint64)
    for name in ("kvchaos/army-obs", "raftlog/army-obs"):
        wl, cfg, plan, lat = port_scenarios()[name]
        jwl, jcfg, jplan, jlat = want[name]
        runs = {}
        for causal in (False, True):
            taps = dict(step_goldens.OBS, causal=causal)
            st = tcore.make_init(wl, cfg, device="cpu", plan_slots=plan.slots, latency=lat,
                                 **taps)(seeds, plan.compile_batch(seeds, wl=wl))
            runs[causal] = state_to_numpy(
                tcore.make_run(wl, cfg, step_goldens.N_STEPS, latency=lat, **taps)(st))
        assert step_goldens.digest_state(jax_order(runs[False])) == GOLDENS[name]
        taps = dict(step_goldens.OBS, causal=True)
        js = je.make_init(jwl, jcfg, time32=False, plan_slots=jplan.slots, latency=jlat,
                          **taps)(seeds, jplan.compile_batch(seeds, wl=jwl))
        jo = jax.jit(je.make_run(jwl, jcfg, step_goldens.N_STEPS, layout="scatter",
                                 time32=False, latency=jlat, **taps))(js)
        assert step_goldens.digest_state(jax_order(runs[True])) == step_goldens.digest_state(jo)
        for f in CAUSAL:
            np.testing.assert_array_equal(runs[True][f], np.asarray(getattr(jo, f)), err_msg=f)
        assert runs[True]["tl_seq"].size and runs[True]["lam"].any()
        for f, v in runs[False].items():
            if f not in (*CAUSAL, "cov", "cov_hits"):
                np.testing.assert_array_equal(runs[True][f], v, err_msg=f)
        assert not np.array_equal(runs[True]["cov"], runs[False]["cov"])


def test_a_causal_step_refuses_a_state_without_the_columns(tmp_path):
    wl, cfg = tm.make_raft(), tcore.EngineConfig(**RAFT_KW)
    st = tcore.make_init(wl, cfg, device="cpu", timeline_cap=8)(seeds_of(4))
    with pytest.raises(ValueError, match=r"lam has shape \(0,\).*causal=True"):
        tcore.make_step_plain(wl, cfg, timeline_cap=8, causal=True)(st)
    # a causal-off checkpoint refuses a causal resume the same way
    path = str(tmp_path / "off.npz")
    save(path, st, cfg)
    with pytest.raises(ValueError, match="causal=True"):
        tcore.make_run(wl, cfg, 20, timeline_cap=8, causal=True)(load(path, cfg, device="cpu"))
    # and a CUDA run's arguments must agree with the state both ways
    on = tcore.make_init(wl, cfg, device="cpu", causal=True)(seeds_of(4))
    with pytest.raises(ValueError, match="causal=False"):
        fused.check_taps(on, False)
    with pytest.raises(ValueError, match="causal=True"):
        fused.check_taps(st, False, timeline_cap=8, causal=True)


def test_checkpoint_round_trip_resumes_bit_identically(tmp_path):
    """A causal mid-run checkpoint (the JAX package's format, both ways)
    resumes to the uninterrupted run, clocks, sidecars and ring
    included."""
    wl, cfg, jcfg = tm.make_raft(), tcore.EngineConfig(**RAFT_KW), je.EngineConfig(**RAFT_KW)
    taps = dict(timeline_cap=128, causal=True)
    seeds = seeds_of(6)
    run = tcore.make_run(wl, cfg, 120, **taps)
    mid = run(tcore.make_init(wl, cfg, device="cpu", **taps)(seeds))
    path = str(tmp_path / "causal.npz")
    save(path, mid, cfg)
    resumed = run(load(path, cfg, device="cpu"))
    straight = run(mid)
    for f in tcore.STATE_FIELDS:
        assert getattr(resumed, f).equal(getattr(straight, f)), f
    jmid = je.load_checkpoint(path, jcfg, time32=False)
    assert_same_state(jmid, mid)
    jrun = jax.jit(je.make_run(jm.make_raft(), jcfg, 120, layout="scatter", time32=False,
                               **taps))
    assert_same_state(jrun(jmid), straight)


def test_determinism_checks_compare_the_causal_columns():
    assert set(CAUSAL) <= set(DERIVED_FIELDS)
    check_determinism(tm.make_raft(), tcore.EngineConfig(**RAFT_KW), seeds_of(4), 200,
                      device="cpu", timeline_cap=64, causal=True)


# ---------------------------------------------------------------- runners

def _elect(m):
    return m.election_safety(tm.raft.OP_ELECT)


@pytest.mark.parametrize("compact", [False, True], ids=["lockstep", "compact"])
def test_search_banks_the_reference_columns(compact):
    """search_seeds(causal=True) with a device screen: the JAX package's
    verdicts, report.lam and ring columns; the axis changes no verdict
    and no trace."""
    kw = dict(n_seeds=12, max_steps=RAFT_STEPS, timeline_cap=256, compact=compact)
    want = je.search_seeds(jm.make_raft(record=True), je.EngineConfig(**RAFT_KW), None,
                           plan=raft_plan(jc), device_check=_elect(jdc), causal=True, **kw)
    got = search_seeds(tm.make_raft(record=True), tcore.EngineConfig(**RAFT_KW), None,
                       device="cpu", plan=raft_plan(tc), device_check=_elect(tdc),
                       causal=True, **kw)
    off = search_seeds(tm.make_raft(record=True), tcore.EngineConfig(**RAFT_KW), None,
                       device="cpu", plan=raft_plan(tc), device_check=_elect(tdc), **kw)
    np.testing.assert_array_equal(got.lam, want.lam)
    for f in (*tcore.TIMELINE_FIELDS, "tl_seq", "tl_parent", "tl_lam"):
        np.testing.assert_array_equal(getattr(got.timeline, f), getattr(want.timeline, f),
                                      err_msg=f)
    for attr in ("ok", "traces", "flagged_idx", "overflowed"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(off, attr), err_msg=attr)
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr), err_msg=attr)
    assert off.lam is None and not hasattr(off.timeline, "tl_seq")
    assert got.lam.shape == (12, 5) and got.lam.dtype == np.uint32


def test_compacted_runner_banks_the_clocks_and_the_ring(tmp_path_factory):
    """Several phases (shrink 2, min_size 4): every banked field the JAX
    package's, lam and the ring's causal columns among them; the pool
    sidecars are not banked."""
    assert {"lam", "tl_seq", "tl_parent", "tl_lam"} <= set(RESULT_FIELDS)
    assert not {"ev_parent", "ev_lam"} & set(RESULT_FIELDS)
    seeds, taps = seeds_of(16), dict(timeline_cap=128, causal=True)
    jcfg, cfg = je.EngineConfig(**RAFT_KW), tcore.EngineConfig(**RAFT_KW)
    jst = je.make_init(jm.make_raft(), jcfg, time32=False, **taps)(seeds)
    want = j_compacted(jm.make_raft(), jcfg, RAFT_STEPS, layout="scatter", time32=False,
                       shrink=2, min_size=4, **taps)(jst)
    got = make_run_compacted(tm.make_raft(), cfg, RAFT_STEPS, shrink=2, min_size=4, **taps)(
        tcore.make_init(tm.make_raft(), cfg, device="cpu", **taps)(seeds))
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
    assert got.lam.any(1).all()


# ---------------------------------------------------------------- lineage

@pytest.fixture(scope="module")
def pingpong():
    """The JAX package's pingpong fixture (rounds=4, seed 0 of 4) captured
    by the port's search with the causal ring."""
    wl = tm.make_pingpong(rounds=4)
    r = search_seeds(wl, tcore.EngineConfig(), lambda v: np.ones(4, bool), n_seeds=4,
                     max_steps=200, timeline_cap=256, causal=True, device="cpu")
    return wl, tobs.decode_timeline(r.timeline, wl, 0)


def test_rederive_equals_the_fold_and_seqs_increase(pingpong, kv_runs):
    wl, ev = pingpong
    assert len(ev) > 10 and rederive(ev) == [e.lam for e in ev]
    # dispatch order is seq order, gap-free on a ring with no dead drops
    assert [e.seq for e in ev] == list(range(len(ev)))
    for i, p in enumerate(derive_parents(ev)):
        if ev[i].parent >= 0:
            # a delivery's emitter dispatched at its sender, a timer's at
            # its own node
            assert p is not None and p < i
            assert ev[p].node == (ev[i].src if ev[i].src >= 0 else ev[i].node)
        else:
            assert p is None
    _seeds, _jo, to = kv_runs
    for s in range(to.seed.shape[0]):
        ev = tobs.decode_timeline(to, None, s)
        assert rederive(ev) == [e.lam for e in ev]
        seqs = [e.seq for e in ev]
        assert all(a < b for a, b in zip(seqs, seqs[1:]))


def test_cones_are_closed_and_hold_their_anchor(kv_runs):
    _seeds, _jo, to = kv_runs
    ev = tobs.decode_timeline(to, None, 3)
    cone = causal_slice(ev)
    assert cone.anchor == len(ev) - 1 and cone.anchor in cone.indices
    member, parents, last, pred = set(cone.indices), derive_parents(ev), {}, []
    for i, e in enumerate(ev):
        pred.append(last.get(e.node))
        last[e.node] = i
    for i in member:
        for j in (parents[i], pred[i]):
            assert j is None or j in member, (i, j)
    assert cone.depth == ev[cone.anchor].lam and 0 < cone.fraction <= 1.0
    from madsim_tpu.obs import causal as jcausal

    text = tobs.format_cone(cone, kv_bug(tm))
    assert "causal cone:" in text and text == jcausal.format_cone(cone, kv_bug(jm))


def test_the_pinned_pingpong_cone_and_the_anchor_forms(pingpong):
    """Event 5 (node 0's delivery from client 2): its cone is exactly
    {0, 1, 2, 3, 5}; event 4, client 1's concurrent delivery, is out."""
    wl, ev = pingpong
    cone = causal_slice(ev, anchor=5)
    assert cone.indices == (0, 1, 2, 3, 5) and cone.depth == 3 and cone.missing_parents == 0
    assert causal_slice(ev, anchor=(ev[5].time_ns, ev[5].node)).indices == cone.indices
    assert causal_slice(ev, anchor=None).anchor == len(ev) - 1
    with pytest.raises(ValueError, match="outside the captured"):
        causal_slice(ev, anchor=len(ev))
    with pytest.raises(ValueError, match="predates the capture"):
        causal_slice(ev, anchor=(-1, 0))
    # the JAX package's obs.causal reads the port's rows the same way
    from madsim_tpu.obs import causal as jcausal

    assert jcausal.causal_slice(ev, anchor=5).indices == cone.indices
    assert tobs.format_cone(cone, wl) == jcausal.format_cone(cone, jm.make_pingpong(rounds=4))


def test_a_ring_without_the_columns_refuses_lineage():
    wl = tm.make_raft()
    r = search_seeds(wl, tcore.EngineConfig(**RAFT_KW), lambda v: np.ones(4, bool), n_seeds=4,
                     max_steps=400, timeline_cap=128, device="cpu")
    ev = tobs.decode_timeline(r.timeline, wl, 0)
    assert ev[0].seq == -1 and ev[0].parent == -1 and ev[0].lam == 0
    with pytest.raises(ValueError, match="causal=True"):
        rederive(ev)
    with pytest.raises(ValueError, match="causal=True"):
        causal_slice(ev)


def test_violation_cones_give_one_cone_per_flagged_seed():
    """The kvchaos-bug screen sweep: every flagged seed's cone, anchored
    at its last completed record, equals the JAX package's."""
    kw = dict(n_seeds=48, max_steps=KV_STEPS, require_halt=False, timeline_cap=512,
              causal=True)
    got = search_seeds(kv_bug(tm), tcore.EngineConfig(**KV_KW), None, device="cpu",
                       plan=kv_plan(tc), device_check=(tdc.stale_reads(),
                                                        tdc.read_your_writes()), **kw)
    want = je.search_seeds(kv_bug(jm), je.EngineConfig(**KV_KW), None, plan=kv_plan(jc),
                           device_check=(jdc.stale_reads(), jdc.read_your_writes()), **kw)
    assert len(got.flagged_idx) > 0
    np.testing.assert_array_equal(got.flagged_idx, want.flagged_idx)
    cones, jcones = tdc.violation_cones(got, kv_bug(tm)), jdc.violation_cones(want)
    assert list(cones) == [int(i) for i in got.flagged_idx] == list(jcones)
    for row, cone in cones.items():
        assert cone.seed == row and cone.anchor in cone.indices
        assert (cone.indices, cone.anchor) == (jcones[row].indices, jcones[row].anchor)


def test_violation_cones_need_flags_and_a_ring():
    wl = tm.make_raft(record=True)
    cfg = tcore.EngineConfig(**RAFT_KW)
    bare = search_seeds(wl, cfg, lambda v: np.ones(4, bool), n_seeds=4, max_steps=400,
                        device="cpu")
    with pytest.raises(ValueError, match="device_check"):
        tdc.violation_cones(bare)
    ringless = search_seeds(wl, cfg, None, n_seeds=4, max_steps=400, device="cpu",
                            device_check=_elect(tdc), causal=True)
    with pytest.raises(ValueError, match="timeline_cap > 0"):
        tdc.violation_cones(ringless)


# ------------------------------------------------------------- fleet shape

@pytest.mark.parametrize("with_lam", [False, True], ids=["met", "met+lam"])
def test_fleet_reduce_equals_the_reference(kv_runs, with_lam):
    _seeds, jo, to = kv_runs
    got = tobs.fleet_reduce(to.met, overflow=to.overflow, lam=to.lam if with_lam else None)
    want = jobs.fleet_reduce(jo.met, overflow=jo.overflow, lam=jo.lam if with_lam else None)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.format(histograms=True) == want.format(histograms=True)
    assert (got.depth_max is not None) == with_lam
    # a host copy (SearchReport's numpy, uint32 clocks) reduces alike
    host = tobs.fleet_reduce(state_to_numpy(to)["met"],
                             lam=state_to_numpy(to)["lam"] if with_lam else None)
    assert host.format() == tobs.fleet_reduce(to.met, lam=to.lam if with_lam else None).format()


def test_fleet_metrics_is_the_reduced_sweep():
    wl, cfg = tm.make_raft(), tcore.EngineConfig(**RAFT_KW)
    fm = tobs.fleet_metrics(wl, cfg, n_seeds=8, max_steps=RAFT_STEPS, device="cpu")
    out = tcore.make_run_while(wl, cfg, RAFT_STEPS, metrics=True)(
        tcore.make_init(wl, cfg, device="cpu", metrics=True)(seeds_of(8)))
    assert fm.format() == tobs.fleet_reduce(out.met, overflow=out.overflow).format()
    with pytest.raises(ValueError, match="MET_"):
        tobs.fleet_reduce(np.zeros((4, 3), np.int32))


# ---------------------------------------------------------------- kernel

@pytest.fixture(scope="module")
def kv_lib(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp("kv_causal"),
                             fused.MODELS["kvchaos-bug-nochaos"], (192,), obs=True)


@pytest.mark.parametrize("ring", [128, 0], ids=["ring", "no-ring"])
def test_host_built_kernel_equals_the_plain_step(kv_lib, kv_runs, ring):
    """kvchaos-bug-nochaos at pool 192 with the axis on, coverage, hit
    counts, metrics and a ring (or none: the sidecars are written all the
    same), against the plain step; the library with the taps carries the
    causal state."""
    seeds, _jo, to = kv_runs
    wl, cfg = kv_bug(tm), tcore.EngineConfig(**KV_KW)
    taps = {**KV_TAPS, "timeline_cap": ring}
    st = tcore.make_init(wl, cfg, device="cpu", plan_slots=kv_plan(tc).slots, **taps)(
        seeds, kv_plan(tc).compile_batch(seeds, wl=wl))
    want = to if ring else tcore.make_run_while_plain(wl, cfg, KV_STEPS, **taps)(st)
    got = host_run(kv_lib, wl, cfg, st, KV_STEPS, True)
    a, b = state_to_numpy(got), state_to_numpy(want)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert a["ev_parent"].max() > 0 and (a["tl_seq"].size > 0) == bool(ring)


def test_host_built_dup_kernel_equals_the_plain_step(tmp_path_factory, arrow_runs):
    """The new kvchaos-bug-nochaos-dup library: shadow rows take the
    dispatch's seq and clock in the kernel too."""
    _jo, to = arrow_runs
    spec = fused.MODELS["kvchaos-bug-nochaos-dup"]
    lib = build_host_kernel(tmp_path_factory.mktemp("kv_dup_causal"), spec, (192,), obs=True)
    wl, cfg, plan = kv_bug(tm), tcore.EngineConfig(**KV_KW), arrow_plan(tc)
    seeds = seeds_of(4) + np.uint64(77)
    taps = dict(metrics=True, timeline_cap=512, causal=True)
    st = tcore.make_init(wl, cfg, device="cpu", plan_slots=plan.slots, **taps)(
        seeds, plan.compile_batch(seeds, wl=wl))
    assert fused.kernel_model(wl, dup_rows=True) is spec
    got = host_run(lib, wl, cfg, st, KV_STEPS, True)
    a, b = state_to_numpy(got), state_to_numpy(to)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_a_causal_state_needs_a_library_with_the_taps():
    wl = tm.make_raft(record=True)
    st = tcore.make_init(wl, tcore.EngineConfig(**RAFT_KW), device="cpu", causal=True)(
        seeds_of(2))
    assert fused.has_obs(st) and not fused.has_obs(
        tcore.make_init(wl, tcore.EngineConfig(**RAFT_KW), device="cpu")(seeds_of(2)))
    # raft-record has no taps build at this pool: the launch builds one
    with pytest.raises(ValueError, match="CUDA"):
        fused.check_state(fused.kernel_model(wl), wl, st)
    lib = fused.library_at(fused.kernel_model(wl), st.ev_valid.shape[1], fused.state_taps(st))
    assert lib.obs_pools == (st.ev_valid.shape[1],) and lib.key.endswith("-obs")
