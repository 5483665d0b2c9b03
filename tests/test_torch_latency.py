"""The tail-latency tap in the torch port against the JAX package: the
ladder, ``LatencySpec`` and the markers; the plain step's latency block
(per-op clocks, the per-seed sketch, the drop counter and the latency
coverage features) at the latency soak's shape and on a hand-built
workload with two markers a call; the tap-off identity; the runners
(``search_seeds(latency=)``, the compacted banks, checkpoints, the
determinism checks); and the sketch's reductions and SLO checks
(``parallel.merge_latency``, ``obs.latency``, ``check.slo`` and
``check.device.slo_breaches``). Exact equality."""

import _torch_threads  # noqa: F401
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import madsim_tpu.engine as je
from madsim_tpu import check as jcheck
from madsim_tpu import obs as jobs
from madsim_tpu.chaos import FaultPlan as JFaultPlan
from madsim_tpu.chaos import GrayFailure as JGrayFailure
from madsim_tpu.models import kvchaos as jkv
from madsim_tpu_torch import check as tcheck
from madsim_tpu_torch import obs as tobs
from madsim_tpu_torch.chaos import FaultPlan, GrayFailure
from madsim_tpu_torch.check import device as tdevice
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.checkpoint import load, save
from madsim_tpu_torch.engine.compact import make_run_compacted
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.engine.search import search_seeds
from madsim_tpu_torch.engine.verify import DERIVED_FIELDS, check_determinism
from madsim_tpu_torch.models import kvchaos as tkv
from madsim_tpu_torch.parallel import merge_latency

from _torch_army import run_plan_both
from _torch_parity import assert_same_state

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import latency_soak  # noqa: E402

SEEDS = np.arange(16, dtype=np.uint64) * np.uint64(6151)
SOAK = dict(writes=20, n_replicas=2, chaos=False, army=True, army_probes=3)
ARMY = dict(n_ops=64, t_min_ns=5_000_000, t_max_ns=500_000_000, n_replicas=2)
GRAY = dict(targets=(0, 3), n_links=1, mult_min=8, mult_max=16, t_min_ns=20_000_000,
            t_max_ns=250_000_000, dur_min_ns=250_000_000, dur_max_ns=450_000_000)
SPEC = dict(ops=64, phases=2, phase_ns=1 << 28)
CFG_KW = dict(pool_size=160, time_limit_ns=700_000_000)
STEPS = 300


def _soak():
    """tools/latency_soak.py's workload and gray plan in both packages."""
    jwl, twl = jkv.make_kvchaos(**SOAK), tkv.make_kvchaos(**SOAK)
    jplan = JFaultPlan((jkv.client_army(**ARMY), JGrayFailure(**GRAY)), name="army-gray")
    tplan = FaultPlan((tkv.client_army(**ARMY), GrayFailure(**GRAY)), name="army-gray")
    assert jplan.hash() == tplan.hash() == latency_soak.FaultPlan(
        (latency_soak.ARMY, latency_soak.GRAY), name="army-gray").hash()
    assert (latency_soak.SPEC, latency_soak.CFG.hash()) == (
        je.LatencySpec(**SPEC), je.EngineConfig(**CFG_KW).hash())
    return jwl, twl, jplan, tplan


@pytest.fixture(scope="module")
def soak_run():
    """The soak's shape at 16 seeds to the end of every run, through both
    engines (the JAX side built once for the module); the port's state."""
    jwl, twl, jplan, tplan = _soak()
    t = run_plan_both(jwl, twl, jplan, tplan, CFG_KW, SEEDS, 4000, lat=SPEC,
                      until_halted=True)
    assert t["halted"].all() and t["lat_count"].sum() > 300
    return t


def test_ladder_and_tokens_equal_the_reference():
    np.testing.assert_array_equal(tcore.LAT_EDGES_NS, je.LAT_EDGES_NS)
    src = (fused.CSRC / "engine_step.cuh").read_text()
    block = src[src.index("#define MADSIM_LAT_EDGES"):src.index("2553802834ll, 3037000500ll")]
    literals = [int(x) for x in re.findall(r"(\d+)ll", block)] + [2553802834, 3037000500]
    assert literals == je.LAT_EDGES_NS.tolist() and tcore.N_LAT_BUCKETS == 64
    v = np.random.default_rng(7).integers(-5, 2**33, 4096)
    v[:64] = je.LAT_EDGES_NS.tolist() + [0]
    np.testing.assert_array_equal(tcore.lat_bucket(v), je.lat_bucket(v))
    b = np.arange(-2, 70)
    np.testing.assert_array_equal(tcore.lat_bucket_lo(b), je.lat_bucket_lo(b))
    np.testing.assert_array_equal(tcore.lat_bucket_hi(b), je.lat_bucket_hi(b))
    tok = tcore.retry_token(np.arange(100), np.arange(100) % 16)
    assert (tok == je.retry_token(np.arange(100), np.arange(100) % 16)).all()
    assert (tcore.retry_token_op(tok) == np.arange(100)).all()
    assert (tcore.retry_token_attempt(tok) == np.arange(100) % 16).all()
    for bad in (dict(ops=0), dict(ops=1, phases=0), dict(ops=1, phase_ns=0)):
        with pytest.raises(ValueError, match="LatencySpec"):
            tcore.LatencySpec(**bad)


def test_markers_and_specs_are_validated():
    eb = tcore.EmitBuilder(2, 0, 2, 4, "cpu")
    with pytest.raises(ValueError, match="lat_markers"):
        eb.lat_start(0)
    eb = tcore.EmitBuilder(2, 0, 2, 4, "cpu", l=1)
    eb.lat_start(0)
    with pytest.raises(ValueError, match="more than lat_markers=1"):
        eb.lat_end(0)
    em = eb.build()
    assert em.lat_valid.shape == (4, 1) and em.lat.tolist() == [[[0, 0]]] * 4
    with pytest.raises(ValueError, match="lat_markers"):
        tcore.Workload("w", 1, 1, (lambda c: None,), lat_markers=-1)
    wl, cfg = tkv.make_kvchaos(**SOAK), tcore.EngineConfig(**CFG_KW)
    with pytest.raises(TypeError, match="LatencySpec"):
        tcore.make_init(wl, cfg, device="cpu", latency=64)
    st = tcore.make_init(wl, cfg, device="cpu")(SEEDS[:2])
    assert st.lat_inv.shape == (2, 0) and st.lat_hist.shape == (2, 0, 0)
    with pytest.raises(ValueError, match="same spec"):
        tcore.make_step_plain(wl, cfg, latency=tcore.LatencySpec(ops=4))(st)
    st = tcore.make_init(wl, cfg, device="cpu", latency=tcore.LatencySpec(ops=4, phases=3))(
        SEEDS[:2])
    assert (st.lat_inv == -1).all() and st.lat_hist.shape == (2, 3, 64)


def test_soak_shape_equals_the_reference_per_field():
    """The latency soak's workload, army and gray failure at 16 seeds:
    every field equal after a fixed run, the five latency columns
    included."""
    jwl, twl, jplan, tplan = _soak()
    t = run_plan_both(jwl, twl, jplan, tplan, CFG_KW, SEEDS, STEPS, lat=SPEC)
    assert t["lat_count"].sum() > 0 and (t["lat_resp"] >= 0).any()
    assert (t["lat_inv"] >= 0).sum() > (t["lat_resp"] >= 0).sum()  # ops still open


def test_the_tap_off_changes_no_other_field(soak_run):
    _jwl, twl, _jp, tplan = _soak()
    cfg = tcore.EngineConfig(**CFG_KW)
    rows = tplan.compile_batch(SEEDS, wl=twl)
    off = state_to_numpy(tcore.make_run_while(twl, cfg, 4000)(
        tcore.make_init(twl, cfg, device="cpu", plan_slots=tplan.slots)(SEEDS, rows)))
    for f, v in off.items():
        if f not in tcore.LATENCY_FIELDS:
            np.testing.assert_array_equal(v, soak_run[f], err_msg=f)
    assert off["lat_hist"].shape == (16, 0, 0)


def test_latency_features_land_in_the_bitmap():
    """With coverage and hit counts on, a completed op's (window,
    bucket) feature is tapped after the record taps: every field equal
    to the reference, and the bitmaps differ from the run without the
    latency tap."""
    jwl, twl, jplan, tplan = _soak()
    taps = dict(cov_words=4, cov_hitcount=True, metrics=True)
    seeds, steps = SEEDS[:8], 200
    t = run_plan_both(jwl, twl, jplan, tplan, CFG_KW, seeds, steps, lat=SPEC, **taps)
    cfg = tcore.EngineConfig(**CFG_KW)
    st = tcore.make_init(twl, cfg, device="cpu", plan_slots=tplan.slots, **taps)(
        seeds, tplan.compile_batch(seeds, wl=twl))
    off = state_to_numpy(tcore.make_run(twl, cfg, steps, **taps)(st))
    assert (off["cov"] != t["cov"]).any() and (off["cov_hits"] != t["cov_hits"]).any()
    np.testing.assert_array_equal(off["trace"], t["trace"])


def _two_marker_workloads():
    """A workload with two marker rows a call, in both packages: node 0
    ticks k = 0..11, each tick starts op k (op 1000 at k = 5, outside
    the columns) and probes node 1, and every third tick also ends op
    k - 1 (before or after its response; op -1 at k = 0); node 1 echoes; the response
    ends op k and starts it again (a repeat start, ignored)."""
    def j_init(ctx):
        eb = ctx.emits()
        eb.after(1_000_000, je.user_kind(1), 0, (jnp.int32(0),), when=ctx.node == 0)
        return ctx.state, eb.build()

    def j_tick(ctx):
        k = ctx.args[0]
        eb = ctx.emits()
        eb.lat_start(jnp.where(k == 5, 1000, k))
        eb.send(1, je.user_kind(2), (k,))
        eb.lat_end(k - 1, when=k % 3 == 0)
        eb.after(2_000_000, je.user_kind(1), 0, (k + 1,), when=k < 11)
        return ctx.state, eb.build()

    def j_echo(ctx):
        eb = ctx.emits()
        eb.send(0, je.user_kind(3), (ctx.args[0],))
        return ctx.state, eb.build()

    def j_resp(ctx):
        eb = ctx.emits()
        eb.lat_end(ctx.args[0])
        eb.lat_start(ctx.args[0])
        return ctx.state, eb.build()

    def t_init(ctx):
        eb = ctx.emits()
        eb.after(1_000_000, tcore.user_kind(1), 0, (0,), when=ctx.node == 0)
        return ctx.state, eb.build()

    def t_tick(ctx):
        k = ctx.args[:, 0]
        eb = ctx.emits()
        eb.lat_start(torch.where(k == 5, 1000, k))
        eb.send(1, tcore.user_kind(2), (k,))
        eb.lat_end(k - 1, when=k % 3 == 0)
        eb.after(2_000_000, tcore.user_kind(1), 0, (k + 1,), when=k < 11)
        return ctx.state, eb.build()

    def t_echo(ctx):
        eb = ctx.emits()
        eb.send(0, tcore.user_kind(3), (ctx.args[:, 0],))
        return ctx.state, eb.build()

    def t_resp(ctx):
        eb = ctx.emits()
        eb.lat_end(ctx.args[:, 0])
        eb.lat_start(ctx.args[:, 0])
        return ctx.state, eb.build()

    kw = dict(name="two-markers", n_nodes=2, state_width=1, max_emits=3, args_words=2,
              lat_markers=2)
    return (je.Workload(handlers=(j_init, j_tick, j_echo, j_resp), **kw),
            tcore.Workload(handlers=(t_init, t_tick, t_echo, t_resp), **kw))


def test_two_markers_fold_in_one_dispatch():
    """L = 2: the markers of one dispatch fold in order, each seeing the
    last one's writes; every field equal to the reference (with
    coverage), an out-of-range op id counted in lat_drop only."""
    jwl, twl = _two_marker_workloads()
    kw = dict(pool_size=16, loss_p=0.1)
    lat = dict(ops=16, phases=2, phase_ns=10_000_000)
    taps = dict(cov_words=2)
    jcfg, tcfg = je.EngineConfig(**kw), tcore.EngineConfig(**kw)
    jl, tl = je.LatencySpec(**lat), tcore.LatencySpec(**lat)
    js = je.make_init(jwl, jcfg, latency=jl, time32=False, **taps)(SEEDS)
    ts = tcore.make_init(twl, tcfg, device="cpu", latency=tl, **taps)(SEEDS)
    jo = jax.jit(je.make_run(jwl, jcfg, 80, layout="scatter", time32=False, latency=jl,
                             **taps))(js)
    to = tcore.make_run(twl, tcfg, 80, latency=tl, **taps)(ts)
    assert_same_state(jo, to)
    t = state_to_numpy(to)
    # op 1000 (tick 5) and op -1 (tick 0 ends k - 1)
    assert (t["lat_drop"] == 2).all()
    # op 5's only start is its response's repeat start, folded after the
    # response's end, which found no start: never completed
    assert (t["lat_resp"][:, 5] < 0).all() and (t["lat_inv"][:, 5] >= 0).any()
    assert (t["lat_count"] > 0).all() and t["lat_hist"].sum() == t["lat_count"].sum()


def test_a_mis_sized_army_is_refused_at_sweep_entry():
    _jwl, twl, _jp, tplan = _soak()
    with pytest.raises(ValueError, match="exceed LatencySpec.ops"):
        search_seeds(twl, tcore.EngineConfig(**CFG_KW), lambda v: np.ones(2, bool),
                     plan=tplan, n_seeds=2, max_steps=10, require_halt=False, device="cpu",
                     latency=tcore.LatencySpec(ops=63))


def test_sketch_reductions_and_quantiles(soak_run):
    t = soak_run
    h = t["lat_hist"]
    whole = merge_latency(h)
    assert (whole == merge_latency(h[:8]) + merge_latency(h[8:])).all()
    assert (whole == merge_latency(torch.from_numpy(h))).all()
    done = (t["lat_inv"] >= 0) & (t["lat_resp"] >= 0)
    lats = (t["lat_resp"] - t["lat_inv"])[done]
    exact = np.bincount(tcore.lat_bucket(lats), minlength=64)
    np.testing.assert_array_equal(whole.sum(0), exact)
    _jwl, twl, _jp, tplan = _soak()
    fl = tobs.fleet_latency(twl, tcore.EngineConfig(**CFG_KW), tcore.LatencySpec(**SPEC),
                            seeds=SEEDS, max_steps=4000, plan=tplan, device="cpu")
    np.testing.assert_array_equal(fl.hist, whole)
    assert fl.completed == int(t["lat_count"].sum()) and fl.dropped == 0
    ref = jobs.latency_reduce(h, t["lat_count"], phase_ns=SPEC["phase_ns"])
    assert fl.format() == ref.format() and fl.quantile(0.99) == ref.quantile(0.99)
    assert fl.max_ns(0) == ref.max_ns(0) and fl.phases == 2
    for q in (0.5, 0.9, 0.99):
        sk = int(tobs.hist_quantile_bucket(whole.sum(0), q))
        assert sk == int(jobs.hist_quantile_bucket(whole.sum(0), q))
        assert abs(sk - int(tcore.lat_bucket(float(np.quantile(lats, q))))) <= 1


@pytest.mark.parametrize("q,min_ops", [(0.99, 16), (0.5, 1), (0.9, 8)])
def test_slo_checks_equal_the_reference(soak_run, q, min_ops):
    rng = np.random.default_rng(11)
    rand = rng.integers(0, 6, (64, 3, 64)).astype(np.int32) * (rng.random((64, 3, 1)) < 0.7)
    for h in (rand, soak_run["lat_hist"]):
        for b in (0, 40, 47, 49, 63):
            bound = int(je.lat_bucket_hi(b))
            want = jcheck.slo.slo_breaches(h, bound, q=q, min_ops=min_ops)
            np.testing.assert_array_equal(tcheck.slo_breaches(h, bound, q=q, min_ops=min_ops),
                                          want)
            got = tdevice.slo_breaches(torch.from_numpy(np.ascontiguousarray(h)), bound, q=q,
                                       min_ops=min_ops)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                tcheck.slo_bounded(bound, q=q, min_ops=min_ops)({"lat_hist": h}),
                jcheck.slo_bounded(bound, q=q, min_ops=min_ops)({"lat_hist": h}))
    with pytest.raises(ValueError, match="LatencySpec"):
        tcheck.slo_bounded(1)({"lat_hist": np.zeros((2, 0, 0))})
    with pytest.raises(ValueError, match="q must be"):
        tdevice.slo_breaches(torch.zeros((1, 1, 64)), 1, q=1.0)


@pytest.fixture(scope="module")
def reference_reports():
    """The JAX package's search over the soak's shape, lockstep and
    compacted, once for the module."""
    jwl, _twl, jplan, _tplan = _soak()
    kw = dict(n_seeds=16, max_steps=4000, plan=jplan, require_halt=False,
              latency=je.LatencySpec(**SPEC))
    inv = jcheck.slo_bounded(319225354, min_ops=8)
    return (je.search_seeds(jwl, je.EngineConfig(**CFG_KW), inv, layout="scatter", **kw),
            je.search_seeds(jwl, je.EngineConfig(**CFG_KW), inv, compact=True, **kw))


@pytest.mark.parametrize("compact", [False, True], ids=["lockstep", "compact"])
def test_search_reports_the_sketch_like_the_reference(reference_reports, compact):
    _jwl, twl, _jp, tplan = _soak()
    want = reference_reports[int(compact)]
    got = search_seeds(twl, tcore.EngineConfig(**CFG_KW), tcheck.slo_bounded(319225354, min_ops=8),
                       n_seeds=16, max_steps=4000, plan=tplan, require_halt=False,
                       latency=tcore.LatencySpec(**SPEC), compact=compact, device="cpu")
    for f in ("traces", "ok", "lat_hist", "lat_count", "lat_dropped", "halted"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert 0 < int((~got.ok).sum()) < 16 and got.plan_hash == want.plan_hash
    assert "dropped latency markers" not in got.banner()


def test_compacted_runner_banks_the_sketch_not_the_clocks(soak_run):
    _jwl, twl, _jp, tplan = _soak()
    cfg, spec = tcore.EngineConfig(**CFG_KW), tcore.LatencySpec(**SPEC)
    st = tcore.make_init(twl, cfg, device="cpu", plan_slots=tplan.slots, latency=spec)(
        SEEDS, tplan.compile_batch(SEEDS, wl=twl))
    co = make_run_compacted(twl, cfg, 4000, latency=spec, min_size=4)(st)
    for f in ("lat_hist", "lat_count", "lat_drop", "trace"):
        np.testing.assert_array_equal(getattr(co, f), soak_run[f], err_msg=f)
    assert not hasattr(co, "lat_inv")


def test_checkpoints_carry_the_latency_columns(tmp_path):
    jwl, twl, jplan, tplan = _soak()
    jcfg, tcfg = je.EngineConfig(**CFG_KW), tcore.EngineConfig(**CFG_KW)
    jl, tl = je.LatencySpec(**SPEC), tcore.LatencySpec(**SPEC)
    seeds = SEEDS[:8]
    ts = tcore.make_init(twl, tcfg, device="cpu", plan_slots=tplan.slots, latency=tl)(
        seeds, tplan.compile_batch(seeds, wl=twl))
    mid = tcore.make_run(twl, tcfg, 150, latency=tl)(ts)
    assert int(mid.lat_count.sum()) > 0
    path = str(tmp_path / "port.npz")
    save(path, mid, tcfg)
    jrun = jax.jit(je.make_run(jwl, jcfg, 150, layout="scatter", time32=False, latency=jl))
    jmid = je.load_checkpoint(path, jcfg)
    assert_same_state(jmid, mid)
    back = str(tmp_path / "jax.npz")
    je.save_checkpoint(back, jrun(jmid), jcfg)
    resumed = load(back, tcfg, device="cpu")
    assert_same_state(je.load_checkpoint(back, jcfg), resumed)
    want = state_to_numpy(tcore.make_run(twl, tcfg, 150, latency=tl)(mid))
    got = state_to_numpy(resumed)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_determinism_checks_cover_the_latency_columns():
    assert set(tcore.LATENCY_FIELDS) <= set(DERIVED_FIELDS)
    _jwl, twl, _jp, tplan = _soak()
    check_determinism(twl, tcore.EngineConfig(**CFG_KW), SEEDS[:8], 200, device="cpu",
                      latency=tcore.LatencySpec(**SPEC), plan=tplan)
