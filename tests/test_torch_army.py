"""The client army in the torch port: ``chaos.ClientArmy`` and the
``army=True`` variants of kvchaos, raftlog, leasekv and shardkv, against
the JAX package per field (the plain step under an army plan, with the
latency tap), and the four army kernel libraries built for the host with
g++ against the plain step. Exact equality."""

import _torch_threads  # noqa: F401
import dataclasses

import numpy as np
import pytest

import madsim_tpu.chaos as jchaos
import madsim_tpu.engine as je
import madsim_tpu.models as jmodels
import madsim_tpu_torch.models as tmodels
from madsim_tpu_torch import chaos as tchaos
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy

from _torch_army import CFG_KW, init_both, plan_pair, run_plan_both
from _torch_host import build_host_kernel, host_run
from _torch_parity import assert_workload_equal

SEEDS = np.arange(16, dtype=np.uint64) * np.uint64(104729)
ARMY_WINDOW = dict(t_min_ns=5_000_000, t_max_ns=300_000_000)
STORM = dict(n=1, t_min_ns=50_000_000, t_max_ns=200_000_000, down_min_ns=20_000_000,
             down_max_ns=80_000_000)

# model -> (factory kwargs, client_army kwargs, crash targets, pool, library)
CASES = {
    "kvchaos": (dict(writes=12, n_replicas=2, chaos=False, army=True, army_probes=3),
                dict(n_ops=16, n_replicas=2), (1, 2), 160, "kvchaos-army-nochaos"),
    "raftlog": (dict(record=True, army=True), dict(n_ops=12), (0, 1, 2, 3, 4), 96,
                "raftlog-record-army"),
    "leasekv": (dict(army=True), dict(n_ops=16), (1, 2, 3), 48, "leasekv-army"),
    "shardkv": (dict(record=True, army=True, chaos=False), dict(n_ops=16),
                (2, 5, 8, 11), 96, "shardkv-record-army-nochaos"),
}


def _models(name):
    return getattr(jmodels, name), getattr(tmodels, name)


def _case(name):
    mk, ak, targets, pool, key = CASES[name]
    jmod, tmod = _models(name)
    jwl, twl = getattr(jmod, f"make_{name}")(**mk), getattr(tmod, f"make_{name}")(**mk)
    jplan, tplan = plan_pair(jmod, tmod, {**ak, **ARMY_WINDOW},
                             ("CrashStorm", dict(targets=targets, **STORM)))
    lat = dict(ops=ak["n_ops"], phases=2)
    return jwl, twl, jplan, tplan, dict(pool_size=pool, **CFG_KW), lat, key


@pytest.mark.parametrize("name", list(CASES))
def test_army_workloads_equal_the_reference(name):
    jwl, twl, *_rest, key = _case(name)
    assert_workload_equal(jwl, twl)
    assert (twl.lat_markers, twl.name) == (jwl.lat_markers, jwl.name) == (1, twl.name)
    assert fused.kernel_model(twl).key == key
    assert fused.workload_shape(twl) == fused.MODELS[key].shape


@pytest.mark.parametrize("name", list(CASES))
def test_army_under_a_crash_storm_equals_the_reference_per_field(name):
    """The variant under its client army and a CrashStorm, with the
    latency tap and the fleet counters: every field equal, ops
    completed."""
    jwl, twl, jplan, tplan, kw, lat, _key = _case(name)
    t = run_plan_both(jwl, twl, jplan, tplan, kw, SEEDS[:8], 300, lat=lat, metrics=True)
    assert t["lat_count"].sum() > 0 and (t["lat_inv"] >= 0).any()
    assert (~t["alive"]).any() or (t["epoch"] > 0).any()


def test_client_army_compiles_and_hashes_like_the_reference():
    jmod, tmod = _models("kvchaos")
    kw = dict(n_ops=8, t_min_ns=1_000, t_max_ns=9_000_000, n_replicas=2, op_base=3)
    ja, ta = jmod.client_army(**kw), tmod.client_army(**kw)
    assert repr(ja) == repr(ta) and ta.targets == (3,) and ta.slots == 8
    assert [dataclasses.astuple(t) for t in ta.slot_templates()] == [
        dataclasses.astuple(t) for t in ja.slot_templates()]
    jr = ja.compile_batch(SEEDS, 5)
    tr = ta.compile_batch(SEEDS, 5)
    for j, t in zip(jr, tr):
        np.testing.assert_array_equal(t, np.asarray(j))
    assert (tr[4] == 3).all() and (tr[2][:, :, 0] == np.arange(3, 11)).all()
    with pytest.raises(ValueError, match="user kind"):
        tchaos.ClientArmy(node=0, kind=3)
    with pytest.raises(ValueError, match="n_ops"):
        tchaos.ClientArmy(node=0, kind=tcore.user_kind(0), n_ops=0)


def test_literal_plan_keeps_the_army_node():
    _jwl, twl, _jp, tplan, kw, lat, _key = _case("kvchaos")
    lit = tplan.literalize(3, wl=twl)
    assert any(e.node == 3 for e in lit.events)
    assert type(lit).from_dict(lit.to_dict()).events == lit.events
    seeds = np.asarray([3], np.uint64)
    spec = tcore.LatencySpec(**lat)
    cfg = tcore.EngineConfig(**kw)
    outs = []
    for p in (tplan, lit):
        st = tcore.make_init(twl, cfg, device="cpu", plan_slots=p.slots, latency=spec)(
            seeds, p.compile_batch(seeds, wl=twl))
        outs.append(state_to_numpy(tcore.make_run(twl, cfg, 200, latency=spec)(st)))
    for f in outs[0]:
        np.testing.assert_array_equal(outs[0][f], outs[1][f], f)


def test_ops_resume_after_a_client_restart():
    """Army rows ride the any-epoch sentinel: a kill and restart of the
    client drops only the op that arrives while it is down."""
    jmod, tmod = _models("kvchaos")
    jwl = jmod.make_kvchaos(writes=12, n_replicas=2, chaos=False, army=True)
    twl = tmod.make_kvchaos(writes=12, n_replicas=2, chaos=False, army=True)
    kind = tmod.client_army(n_replicas=2).kind
    ev = ((50_000_000, kind, 0, 3), (150_000_000, kind, 1, 3), (300_000_000, kind, 2, 3),
          (100_000_000, tcore.KIND_KILL, 3, 0), (200_000_000, tcore.KIND_RESTART, 3, 0))
    jlit = jchaos.LiteralPlan(events=tuple(
        jchaos.FaultEvent(t=t, kind=k, a0=a0, node=n) for t, k, a0, n in ev))
    tlit = tchaos.LiteralPlan(events=tuple(
        tchaos.FaultEvent(t=t, kind=k, a0=a0, node=n) for t, k, a0, n in ev))
    assert jlit.hash() == tlit.hash()
    t = run_plan_both(jwl, twl, jlit, tlit, dict(pool_size=64, time_limit_ns=450_000_000),
                      SEEDS[:4], 1500, lat=dict(ops=3), until_halted=True)
    assert (t["lat_inv"][:, 0] >= 0).all() and (t["lat_resp"][:, 0] >= 0).all()
    assert (t["lat_inv"][:, 1] < 0).all()  # arrived at a dead client
    assert (t["lat_inv"][:, 2] >= 0).all() and (t["lat_resp"][:, 2] >= 0).all()
    assert (t["lat_count"] == 2).all()


def test_an_army_needs_the_client_surface():
    _jwl, twl, _jp, tplan, *_rest = _case("kvchaos")
    no_army = tmodels.make_kvchaos(writes=4, n_replicas=2, chaos=False)
    with pytest.raises(ValueError, match="client surface"):
        tplan.compile_batch(np.arange(2, dtype=np.uint64), wl=no_army)
    with pytest.raises(ValueError, match="client surface"):
        tplan.literalize(0, wl=twl).compile_batch(np.arange(2, dtype=np.uint64), wl=no_army)


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError) as exc:
        return type(exc).__name__, str(exc)
    return None


def test_retries_wait_for_the_retry_axis():
    """The retry axis is ported: a policy builds and validates as the JAX
    package's, a client army carries it and compiles it into the engine's
    spec, and the errors are the reference's word for word."""
    pol = dict(timeout_ns=10_000_000, max_attempts=4, backoff_base_ns=1_000_000, jitter=0.5)
    t_army = tchaos.ClientArmy(node=1, kind=tcore.user_kind(15), n_ops=8, op_base=3,
                               retry=tchaos.RetryPolicy(**pol))
    j_army = jchaos.ClientArmy(node=1, kind=je.user_kind(15), n_ops=8, op_base=3,
                               retry=jchaos.RetryPolicy(**pol))
    assert repr(t_army.retry_spec()) == repr(j_army.retry_spec())
    assert repr(t_army) == repr(j_army)
    for bad in (dict(timeout_ns=0), dict(timeout_ns=1, max_attempts=0),
                dict(timeout_ns=1, jitter=-0.1), dict(timeout_ns=1, backoff_mult=0.9)):
        got = _error(lambda: tchaos.RetryPolicy(**bad))
        assert got is not None and got == _error(lambda: jchaos.RetryPolicy(**bad))
    for kw in (dict(retry=object()), dict(op_base=(1 << 26) - 2, n_ops=4,
                                          retry=tchaos.RetryPolicy(timeout_ns=1))):
        got = _error(lambda: tchaos.ClientArmy(node=1, kind=tcore.user_kind(15), **kw))
        jkw = {**kw, "retry": jchaos.RetryPolicy(timeout_ns=1)} if "n_ops" in kw else kw
        assert got is not None and got == _error(
            lambda: jchaos.ClientArmy(node=1, kind=je.user_kind(15), **jkw))
    with pytest.raises(ValueError, match="no RetryPolicy"):
        tchaos.ClientArmy(node=1, kind=tcore.user_kind(15)).retry_spec()
    with pytest.raises(ValueError, match="army_probes"):
        tmodels.make_kvchaos(army=True, army_probes=0)


@pytest.mark.parametrize("name", list(CASES))
def test_host_built_army_kernel_with_the_tap_matches_the_plain_step(tmp_path_factory, name):
    """The army library's device code (engine_step.cuh's latency fold
    and the trait's army handlers) built with g++, under the army plan
    with the latency tap on (raftlog also with every observability tap),
    equals the plain step per field, fixed steps and run-until-halted."""
    _jwl, twl, _jp, tplan, kw, lat, key = _case(name)
    cfg = tcore.EngineConfig(**kw)
    spec = tcore.LatencySpec(**lat)
    taps = (dict(cov_words=8, cov_hitcount=True, timeline_cap=48, metrics=True)
            if name == "raftlog" else {})
    lib = build_host_kernel(tmp_path_factory.mktemp(key), fused.MODELS[key], (kw["pool_size"],),
                            obs=bool(taps))
    seeds = SEEDS[:8]
    st = tcore.make_init(twl, cfg, device="cpu", plan_slots=tplan.slots, latency=spec,
                         **taps)(seeds, tplan.compile_batch(seeds, wl=twl))
    for n, until in ((200, False), (2000, True)):
        plain = tcore.make_run_while_plain if until else tcore.make_run_plain
        want = state_to_numpy(plain(twl, cfg, n, latency=spec, **taps)(st))
        got = state_to_numpy(host_run(lib, twl, cfg, st, n, until, latency=spec))
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"{name} {n} {f}")
        assert want["lat_count"].sum() > 0


def test_the_registry_refuses_other_army_shapes():
    """Other army shapes derive their own libraries, with the markers."""
    for wl, key in ((tmodels.make_kvchaos(n_replicas=3, army=True), "kvchaos-army-r3"),
                    (tmodels.make_raftlog(army=True), "raftlog-army")):  # chaos on, no record
        spec = fused.kernel_model(wl)
        assert spec.key == key and spec.lat == wl.lat_markers == 1
        assert spec.shape == fused.workload_shape(wl)
    # an army workload never matches a library without markers
    assert all(m.lat == 0 for m in fused.MODELS.values() if "army" not in m.key)
