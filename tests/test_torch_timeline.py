"""The timeline ring and the coverage bitmap through the port's runners
and its decoder, against the JAX package.

* ``obs.decode_timeline`` of the port's ring gives the JAX decoder's
  rows (time, kind, node, src, args, payload, emit time) on raftlog
  ``durable=True`` under a disk-fault plan (a payload workload), and
  ``obs.refold_timeline`` gives back every seed's trace.
* ``search_seeds(cov_words=, cov_hitcount=, timeline_cap=)``, lockstep
  and compacted: the JAX package's bitmaps, ring columns, overflow flags
  and banner (a ring that overflows is named there); verdicts and
  traces equal the search without the taps.
* ``make_run_compacted`` banks ``cov`` and the ring like the JAX
  package's, over several phases; one stop-at-halt launch of the run
  kernel's step code (built with g++) banks the same.
* Checkpoints carry the columns both ways: a JAX checkpoint taken with
  ``timeline_cap > 0`` and coverage loads in the port and resumes to
  the uninterrupted run, and the port's loads in the JAX package.
* ``check_determinism`` compares the tap columns.

Exact equality throughout.
"""

import numpy as np
import pytest

import jax

import madsim_tpu.chaos as jc
import madsim_tpu.engine as je
import madsim_tpu.obs as jobs
from madsim_tpu.engine.compact import make_run_compacted as j_compacted
from madsim_tpu.models import make_raft as j_raft
from madsim_tpu.models import make_raftlog as j_raftlog
from madsim_tpu_torch import chaos as tc
from madsim_tpu_torch import obs as tobs
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.checkpoint import load, save
from madsim_tpu_torch.engine.compact import RESULT_FIELDS, make_run_compacted, one_launch_banks
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.engine.search import search_seeds
from madsim_tpu_torch.engine.verify import DERIVED_FIELDS, check_determinism
from madsim_tpu_torch.models import make_raft, make_raftlog

from _torch_host import build_host_kernel, host_launch
from _torch_parity import assert_same_state
from test_torch_coverage import disk_plan

SEEDS = np.arange(8, dtype=np.uint64)
RAFT_KW = dict(pool_size=40, loss_p=0.02)
RLOG_KW = dict(pool_size=64, loss_p=0.02)
TAPS = dict(cov_words=64, cov_hitcount=True, timeline_cap=128)
ROW = ("time_ns", "kind", "node", "src", "args", "pay", "emit_ns")


@pytest.fixture(scope="module")
def raftlog_runs():
    """raftlog durable=True under the disk plan, with every tap, in both
    packages."""
    jwl, twl = j_raftlog(durable=True), make_raftlog(durable=True)
    jp, tp = disk_plan(jc), disk_plan(tc)
    jst = je.make_init(jwl, je.EngineConfig(**RLOG_KW), time32=False, plan_slots=jp.slots,
                       **TAPS)(SEEDS, jp.compile_batch(SEEDS, wl=jwl))
    want = jax.jit(je.make_run_while(jwl, je.EngineConfig(**RLOG_KW), 4000, layout="scatter",
                                     time32=False, **TAPS))(jst)
    tst = tcore.make_init(twl, tcore.EngineConfig(**RLOG_KW), device="cpu", plan_slots=tp.slots,
                          **TAPS)(SEEDS, tp.compile_batch(SEEDS, wl=twl))
    got = tcore.make_run_while_plain(twl, tcore.EngineConfig(**RLOG_KW), 4000, **TAPS)(tst)
    return jwl, want, twl, got


def test_decode_matches_the_reference_and_refolds_to_the_trace(raftlog_runs):
    jwl, want, twl, got = raftlog_runs
    assert_same_state(want, got)
    traces = state_to_numpy(got)["trace"]
    for i in range(len(SEEDS)):
        rows = tobs.decode_timeline(got, twl, i)
        ref = jobs.decode_timeline(want, jwl, i)
        assert [tuple(getattr(e, f) for f in ROW) for e in rows] == [
            tuple(getattr(e, f) for f in ROW) for e in ref]
        assert len(rows) == int(got.tl_count[i]) > 0 and int(got.tl_drop[i]) == 0
        assert tobs.refold_timeline(rows, twl) == int(traces[i])
        # a message row was emitted before it was dispatched; the init
        # and plan rows at 0
        assert all(0 <= e.emit_ns <= e.time_ns for e in rows)
        assert any(e.emit_ns > 0 for e in rows) and any(e.pay != (0,) * 4 for e in rows)
    assert tobs.timeline_counts(got)[0].tolist() == got.tl_count.tolist()
    with pytest.raises(ValueError, match="timeline_cap > 0"):
        tobs.decode_timeline(tcore.make_init(twl, tcore.EngineConfig(**RLOG_KW),
                                             device="cpu")(SEEDS), twl, 0)


def has_leader(view):
    return (view["node_state"][:, :, 0] == 2).any(1)


@pytest.mark.parametrize("compact", [False, True], ids=["lockstep", "compact"])
def test_search_returns_the_reference_bitmaps_and_rings(compact):
    taps = dict(cov_words=64, cov_hitcount=True, timeline_cap=16)
    kw = dict(n_seeds=24, max_steps=600, compact=compact)
    want = je.search_seeds(j_raft(), je.EngineConfig(**RAFT_KW), has_leader, **kw, **taps)
    got = search_seeds(make_raft(), tcore.EngineConfig(**RAFT_KW), has_leader, device="cpu",
                       **kw, **taps)
    off = search_seeds(make_raft(), tcore.EngineConfig(**RAFT_KW), has_leader, device="cpu",
                       **kw)
    np.testing.assert_array_equal(got.cov, want.cov)
    for f in tcore.TIMELINE_FIELDS:
        np.testing.assert_array_equal(getattr(got.timeline, f), getattr(want.timeline, f),
                                      err_msg=f)
    np.testing.assert_array_equal(got.tl_dropped, want.tl_dropped)
    assert got.tl_dropped.any() and "overflowed the timeline ring" in got.banner()
    assert got.banner() == want.banner()
    # a dropped row voids nothing: the verdicts are the search's without taps
    for attr in ("ok", "overflowed", "traces", "failing_seeds"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(off, attr), err_msg=attr)
    assert off.cov is None and off.timeline is None and "timeline" not in off.banner()
    i = int(np.nonzero(~got.tl_dropped)[0][0])
    assert tobs.refold_timeline(tobs.decode_timeline(got.timeline, None, i),
                                make_raft()) == int(got.traces[i])


@pytest.fixture(scope="module")
def raft_lib(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp("raft_obs"), fused.MODELS["raft"],
                             (RAFT_KW["pool_size"],), obs=True)


def test_compacted_runner_banks_cov_and_the_ring(raft_lib):
    """Several phases (shrink 2, min_size 4), every banked field the JAX
    package's; the stop-at-halt launch of the host build banks the same."""
    seeds = np.arange(16, dtype=np.uint64)
    cfg = tcore.EngineConfig(**RAFT_KW)
    jst = je.make_init(j_raft(), je.EngineConfig(**RAFT_KW), time32=False, **TAPS)(seeds)
    want = j_compacted(j_raft(), je.EngineConfig(**RAFT_KW), 600, layout="scatter", time32=False,
                       shrink=2, min_size=4, **TAPS)(jst)
    st = tcore.make_init(make_raft(), cfg, device="cpu", **TAPS)(seeds)
    run = make_run_compacted(make_raft(), cfg, 600, shrink=2, min_size=4, **TAPS)
    got = run(st)
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
    assert "cov_hits" not in RESULT_FIELDS and got.cov.any(1).all()
    out, iters, _tmax = host_launch(raft_lib, make_raft(), cfg, st, 600, True)
    card = run.assemble(one_launch_banks(st, out, iters, RESULT_FIELDS))
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(card, f), getattr(got, f), err_msg=f)


def test_checkpoints_carry_the_columns_both_ways(tmp_path):
    jcfg, cfg = je.EngineConfig(**RAFT_KW), tcore.EngineConfig(**RAFT_KW)
    jrun = jax.jit(je.make_run(j_raft(), jcfg, 25, layout="scatter", time32=False, **TAPS))
    jmid = jrun(je.make_init(j_raft(), jcfg, time32=False, **TAPS)(SEEDS))
    path = str(tmp_path / "ref.npz")
    je.save_checkpoint(path, jmid, jcfg)
    mid = load(path, cfg, device="cpu")
    assert_same_state(jmid, mid)
    assert (mid.tl_count > 0).all() and mid.ev_emit.shape == (len(SEEDS), 40)
    run = tcore.make_run_plain(make_raft(), cfg, 25, **TAPS)
    whole = tcore.make_run_plain(make_raft(), cfg, 50, **TAPS)(
        tcore.make_init(make_raft(), cfg, device="cpu", **TAPS)(SEEDS))
    resumed = run(mid)
    for f in tcore.STATE_FIELDS:
        assert getattr(resumed, f).equal(getattr(whole, f)), f
    # and the port's file in the JAX package
    path = str(tmp_path / "port.npz")
    save(path, resumed, cfg)
    assert_same_state(je.load_checkpoint(path, jcfg, time32=False), resumed)
    assert_same_state(jrun(jmid), resumed)


def test_determinism_checks_compare_the_tap_columns():
    assert {"cov", "cov_hits", "tl_t", "ev_emit", "tl_emit"} <= set(DERIVED_FIELDS)
    check_determinism(make_raft(), tcore.EngineConfig(**RAFT_KW), SEEDS, 200, device="cpu",
                      **TAPS)
