"""The client-retry axis in the torch port against the JAX package, case
for case with the JAX package's ``tests/test_retry.py``: the policy-off
identity (zero-size columns, the same compiled rows, the retry counters
at zero), the pinned kvchaos army under a gray failure through the plain
step and the compacted runner, the schedule (tokens, the backoff tables,
the spec's validation, the same seed giving the same attempts), the
starved army's exact books, checkpoints, ``search_seeds`` deriving the
policy from the plan, the Perfetto arrow labels, and the policy with the
causal axis and its Perfetto document. Both engines run in this process,
the JAX one on the CPU with ``layout="scatter", time32=False``; every
comparison is exact (the engine is integer arithmetic)."""

import _torch_threads  # noqa: F401
import dataclasses
import json

import numpy as np
import pytest

import madsim_tpu.engine as je
from madsim_tpu import obs as jobs
from madsim_tpu.engine.core import _retry_backoff_tables as j_tables
from madsim_tpu.engine.replay import ReplayEvent as JEvent
from madsim_tpu_torch import obs as tobs
from madsim_tpu_torch.chaos import FaultPlan, Partition, RetryPolicy
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.checkpoint import load, save
from madsim_tpu_torch.engine.compact import RESULT_FIELDS, make_run_compacted
from madsim_tpu_torch.engine.convert import field_to_numpy, state_to_numpy
from madsim_tpu_torch.engine.core import (
    MET_RETRY,
    MET_RETRY_GIVEUP,
    N_METRICS,
    RETRY_STATE_FIELDS,
    RetrySpec,
    _retry_backoff_tables,
    retry_token,
    retry_token_attempt,
    retry_token_op,
)
from madsim_tpu_torch.engine.replay import ReplayEvent
from madsim_tpu_torch.engine.search import search_seeds
from madsim_tpu_torch.models import kvchaos as tkv

import madsim_tpu.chaos as jchaos
import madsim_tpu.models as jmodels

from _torch_retry import (
    CFG_KW, KV_MAKE, N_OPS, SPEC_KW, STEPS, kv_plan, kv_policy, pkg, run_both, seeds_of,
)

SEEDS = seeds_of(6)
TAPS = dict(metrics=True)


def _wl(port=True):
    return (tkv.make_kvchaos if port else jmodels.make_kvchaos)(**KV_MAKE)


@pytest.fixture(scope="module")
def pinned():
    """The pinned shape with the policy and without it, 6 seeds to the
    end of the run, through both engines: ``{on, off: (JAX, port)}``."""
    return {
        key: run_both(_wl(False), _wl(), kv_plan(False, policy=key == "on"),
                      kv_plan(True, policy=key == "on"), CFG_KW, SEEDS, STEPS,
                      lat=SPEC_KW, **TAPS)
        for key in ("on", "off")
    }


def _init(plan, retry, seeds=SEEDS, **taps):
    wl = _wl()
    return tcore.make_init(wl, tcore.EngineConfig(**CFG_KW), device="cpu", plan_slots=plan.slots,
                           latency=tcore.LatencySpec(**SPEC_KW), retry=retry, **taps)(
        seeds, plan.compile_batch(seeds, wl=wl))


# ------------------------------------------------------------- identity
def test_retry_off_columns_are_zero_size():
    plan = kv_plan(True)
    off, on = _init(plan, None, **TAPS), _init(plan, plan.retry_spec(), **TAPS)
    for f in RETRY_STATE_FIELDS:
        assert getattr(off, f).numel() == 0, f
        assert tuple(getattr(on, f).shape) == (len(SEEDS), N_OPS), f
        assert not getattr(on, f).any(), f
    assert tuple(off.met.shape) == (len(SEEDS), N_METRICS) and N_METRICS == MET_RETRY_GIVEUP + 1


def test_policy_changes_no_compiled_row():
    """The plan compiles to the same rows with and without the policy
    (attempt-0 tokens are plain op ids), and its hash is the JAX
    package's either way."""
    seeds = seeds_of(8)
    wl = _wl()
    r_on = kv_plan(True).compile_batch(seeds, wl=wl)
    r_off = kv_plan(True, policy=False).compile_batch(seeds, wl=wl)
    for f in ("time", "kind", "args", "valid", "node"):
        np.testing.assert_array_equal(getattr(r_on, f), getattr(r_off, f), f)
    for policy in (True, False):
        assert kv_plan(True, policy).hash() == kv_plan(False, policy).hash()


@pytest.mark.parametrize("runner", ["plain", "compact"])
def test_retry_off_identity(pinned, runner):
    """Without a policy the port equals the JAX engine per field, the
    retry counters stay zero and the compacted runner banks the plain
    step's results."""
    _jo, to = pinned["off"]
    assert to.met[:, MET_RETRY:].sum() == 0 and to.rt_done.numel() == 0
    if runner == "compact":
        plan = kv_plan(True, policy=False)
        co = make_run_compacted(_wl(), tcore.EngineConfig(**CFG_KW), STEPS, min_size=8,
                                latency=tcore.LatencySpec(**SPEC_KW), **TAPS)(_init(plan, None, **TAPS))
        for f in RESULT_FIELDS:
            np.testing.assert_array_equal(getattr(co, f), field_to_numpy(f, getattr(to, f)), f)


@pytest.mark.parametrize("runner", ["plain", "compact"])
def test_retry_on_parity(pinned, runner):
    """Under the policy the port equals the JAX engine per field (the
    fixture holds it, the three columns and all 18 counters included),
    re-sends happen, and the compacted runner banks the plain step's
    results (its banks hold no retry columns, as the reference's)."""
    jo, to = pinned["on"]
    assert to.met[:, MET_RETRY].sum() > 0 and to.rt_done.any() and to.rt_deadline.any()
    if runner == "compact":
        plan = kv_plan(True)
        assert not set(RETRY_STATE_FIELDS) & set(RESULT_FIELDS)
        co = make_run_compacted(_wl(), tcore.EngineConfig(**CFG_KW), STEPS, min_size=8,
                                latency=tcore.LatencySpec(**SPEC_KW), retry=plan.retry_spec(),
                                **TAPS)(_init(plan, plan.retry_spec(), **TAPS))
        for f in RESULT_FIELDS:
            np.testing.assert_array_equal(getattr(co, f), np.asarray(getattr(jo, f)), f)


def test_retry_changes_the_trajectory(pinned):
    """The policy is core state: a seed that re-sent has another trace
    than the fire-and-forget run."""
    on, off = pinned["on"][1], pinned["off"][1]
    retried = (on.met[:, MET_RETRY] > 0).numpy()
    assert retried.any()
    assert (on.trace != off.trace).numpy()[retried].all()


# ------------------------------------------------------------- schedule
def test_token_packing_roundtrip():
    for op in (0, 7, (1 << 26) - 1):
        for att in (0, 1, 15):
            tok = retry_token(op, att)
            assert (retry_token_op(tok), retry_token_attempt(tok)) == (op, att)
            assert tok == je.retry_token(op, att)
    assert retry_token(9, 0) == 9


def test_backoff_table_pin():
    rt = RetrySpec(kind=16, node=0, op_base=0, n_ops=4, timeout_ns=1, max_attempts=4,
                   backoff_base_ns=10_000_000, backoff_mult=2.0, jitter=0.5)
    boff, bjit = _retry_backoff_tables(rt)
    assert boff == (0, 10_000_000, 20_000_000, 40_000_000, 80_000_000)
    assert bjit == (0, 5_000_000, 10_000_000, 20_000_000, 40_000_000)
    # the host float arithmetic and the cap are the reference's
    for kw in (dict(backoff_base_ns=3, backoff_mult=1.7, jitter=0.33, max_attempts=15),
               dict(backoff_base_ns=1 << 30, backoff_mult=3.0, jitter=1.0, max_attempts=6)):
        spec = dict(kind=16, node=0, op_base=0, n_ops=4, timeout_ns=1, **kw)
        assert _retry_backoff_tables(RetrySpec(**spec)) == j_tables(je.RetrySpec(**spec))


def _message(fn):
    try:
        fn()
    except (ValueError, TypeError) as exc:
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("bad", [
    dict(max_attempts=16), dict(op_base=(1 << 26) - 2), dict(kind=2), dict(jitter=1.5),
    dict(n_ops=0), dict(timeout_ns=0), dict(op_base=-1), dict(backoff_base_ns=-1),
    dict(backoff_mult=0.5),
])
def test_spec_validation(bad):
    """Each bad field raises the JAX package's error, word for word, from
    the spec and from the policy (which validates through the spec)."""
    ok = dict(kind=16, node=0, op_base=0, n_ops=4, timeout_ns=1)
    RetrySpec(**ok)
    got = _message(lambda: RetrySpec(**{**ok, **bad}))
    assert got is not None and got == _message(lambda: je.RetrySpec(**{**ok, **bad}))
    pol = {k: v for k, v in bad.items() if k in ("max_attempts", "jitter", "timeout_ns",
                                                  "backoff_base_ns", "backoff_mult")}
    if pol:
        base = dict(timeout_ns=1)
        assert _message(lambda: RetryPolicy(**{**base, **pol})) == \
            _message(lambda: jchaos.RetryPolicy(**{**base, **pol}))


def test_same_seed_same_attempt_schedule(pinned):
    """Another build of the same policied run agrees on every field."""
    plan = kv_plan(True)
    rt = plan.retry_spec()
    again = tcore.make_run_while(_wl(), tcore.EngineConfig(**CFG_KW), STEPS,
                                 latency=tcore.LatencySpec(**SPEC_KW), retry=rt, **TAPS)(
        _init(kv_plan(True), rt, **TAPS))
    want = state_to_numpy(pinned["on"][1])
    for f, v in state_to_numpy(again).items():
        np.testing.assert_array_equal(v, want[f], f)


# ------------------------------------------------------------- give-ups
def test_starved_army_gives_up_exactly():
    """The client cut off from the primary for the whole horizon: each op
    delivers max_attempts times and is abandoned; 12 re-sends and 6
    give-ups a seed, nothing completes, as in the JAX engine."""
    wl_kw = dict(writes=4, n_replicas=2, chaos=False, army=True)

    def plan(port):
        ch, m = pkg(port)
        m = m.kvchaos
        pol = ch.RetryPolicy(timeout_ns=20_000_000, max_attempts=3, backoff_base_ns=5_000_000,
                             backoff_mult=2.0)
        return ch.FaultPlan(
            (m.client_army(n_ops=6, t_min_ns=5_000_000, t_max_ns=80_000_000, n_replicas=2,
                           retry=pol),
             ch.Partition(targets=(0, 3), t_min_ns=1, t_max_ns=2, dur_min_ns=900_000_000,
                          dur_max_ns=900_000_001)),
            name="starve")

    assert Partition is type(plan(True).specs[1])
    _jo, to = run_both(jmodels.make_kvchaos(**wl_kw), tkv.make_kvchaos(**wl_kw), plan(False),
                       plan(True), dict(pool_size=80, time_limit_ns=700_000_000), seeds_of(8),
                       5000, lat=dict(ops=6), metrics=True)
    met = to.met.numpy()
    assert (met[:, MET_RETRY] == 12).all() and (met[:, MET_RETRY_GIVEUP] == 6).all()
    assert not to.rt_done.any() and not to.lat_hist.any() and to.halted.all()


# ----------------------------------------------------------- checkpoint
def test_retry_roundtrip_resumes_identically(tmp_path):
    plan = kv_plan(True)
    rt = plan.retry_spec()
    cfg = tcore.EngineConfig(**CFG_KW)
    kw = dict(latency=tcore.LatencySpec(**SPEC_KW), retry=rt, **TAPS)
    run = tcore.make_run(_wl(), cfg, 300, **kw)
    mid = run(_init(plan, rt, seeds_of(4), **TAPS))
    # armed deadlines are in flight at the cut
    assert mid.rt_deadline.max() > 0
    path = str(tmp_path / "retry.npz")
    save(path, mid, cfg)
    resumed = run(load(path, cfg, device="cpu", retry=rt))
    straight = state_to_numpy(run(mid))
    for f, v in state_to_numpy(resumed).items():
        np.testing.assert_array_equal(v, straight[f], f)


def test_mismatched_axes_refused_both_directions(tmp_path):
    """The JAX package's refusals, word for word, on the port's files."""
    cfg = tcore.EngineConfig(**CFG_KW)
    plan = kv_plan(True)
    rt = plan.retry_spec()
    p_on, p_off = str(tmp_path / "on.npz"), str(tmp_path / "off.npz")
    save(p_on, _init(plan, rt, seeds_of(2)), cfg)
    save(p_off, _init(plan, None, seeds_of(2)), cfg)
    jcfg = je.EngineConfig(**CFG_KW)
    jrt = kv_plan(False).retry_spec()
    cases = [(p_on, None, None), (p_off, rt, jrt),
             (p_on, dataclasses.replace(rt, n_ops=8), dataclasses.replace(jrt, n_ops=8))]
    for path, t_rt, j_rt in cases:
        with pytest.raises(ValueError) as got:
            load(path, cfg, device="cpu", retry=t_rt)
        with pytest.raises(ValueError) as want:
            je.load_checkpoint(path, jcfg, retry=j_rt)
        assert str(got.value) == str(want.value)
    assert tuple(load(p_on, cfg, device="cpu", retry=rt).rt_done.shape) == (2, N_OPS)
    assert load(p_off, cfg, device="cpu").rt_done.numel() == 0


# ------------------------------------------------------- search wiring
def test_search_seeds_derives_retry_from_plan(pinned):
    """``search_seeds(plan=...)`` arms the timers from the plan's own
    policy: its counters are the pinned run's."""
    ones = lambda v: np.ones(np.asarray(v["halted"]).shape[0], bool)  # noqa: E731
    r = search_seeds(_wl(), tcore.EngineConfig(**CFG_KW), ones, n_seeds=4, max_steps=STEPS,
                     plan=kv_plan(True), latency=tcore.LatencySpec(**SPEC_KW), metrics=True,
                     require_halt=False, device="cpu")
    np.testing.assert_array_equal(r.met, np.asarray(pinned["on"][0].met)[:4])
    assert r.met[:, MET_RETRY].sum() > 0


def test_two_policied_armies_refused():
    def plan(port):
        ch, m = pkg(port)
        m = m.kvchaos
        pol = kv_policy(ch)
        return ch.FaultPlan((m.client_army(n_ops=4, n_replicas=2, retry=pol),
                             m.client_army(n_ops=4, n_replicas=2, op_base=4, retry=pol)),
                            name="double")

    with pytest.raises(ValueError, match="one retried op range") as got:
        plan(True).retry_spec()
    with pytest.raises(ValueError) as want:
        plan(False).retry_spec()
    assert str(got.value) == str(want.value)
    assert kv_plan(True, policy=False).retry_spec() is None


# ------------------------------------------------- perfetto arrow labels
def _events(cls, att):
    tok = retry_token(7, att)
    return [
        cls(time_ns=1_000, kind=16, node=1, src=-1, args=(0, 0), pay=()),
        cls(time_ns=5_000, kind=16, node=0, src=1, args=(tok, 0), pay=(), emit_ns=1_000),
    ]


@pytest.mark.parametrize("case", ["attempt", "attempt-zero", "engine-kind"])
def test_perfetto_labels(case):
    """A re-sent op's arrow is named by (op, attempt); attempt-0 and
    engine-kind rows keep the plain label; the documents are the JAX
    package's."""
    if case == "engine-kind":
        from madsim_tpu.obs.perfetto import _flow_name as j_name
        from madsim_tpu_torch.obs.perfetto import _flow_name as t_name

        args = (retry_token(7, 2), 0)
        assert t_name(ReplayEvent(time_ns=1, kind=2, node=0, src=1, args=args, pay=())) == \
            j_name(JEvent(time_ns=1, kind=2, node=0, src=1, args=args, pay=())) == "msg n1->n0"
        return
    att = 2 if case == "attempt" else 0
    doc = tobs.to_perfetto(_events(ReplayEvent, att))
    assert json.dumps(doc, sort_keys=True) == json.dumps(
        jobs.to_perfetto(_events(JEvent, att)), sort_keys=True)
    flows = [e for e in doc["traceEvents"] if e.get("cat") == "flow"]
    want = "msg n1->n0 op7 try2" if att else "msg n1->n0"
    assert flows and all(e["name"] == want for e in flows)


# ------------------------------------------------- with the causal axis
def test_retry_with_the_causal_axis():
    """The policied army with causal provenance, a ring and coverage: the
    six causal columns and every other field equal the JAX engine's, and
    each seed's Perfetto document equals the JAX package's as JSON."""
    taps = dict(metrics=True, causal=True, timeline_cap=256, cov_words=8)
    seeds = seeds_of(4)
    jo, to = run_both(_wl(False), _wl(), kv_plan(False), kv_plan(True), CFG_KW, seeds, STEPS,
                      lat=SPEC_KW, **taps)
    assert to.met[:, MET_RETRY].sum() > 0 and to.tl_seq.any() and not to.tl_drop.any()
    kind = kv_plan(True).retry_spec().kind
    retried = 0
    for s in range(len(seeds)):
        jev = jobs.decode_timeline(jo, _wl(False), s)
        tev = tobs.decode_timeline(to, _wl(), s)
        got = tobs.to_perfetto(tev, name="kvchaos-army", seed=s)
        want = jobs.to_perfetto(jev, name="kvchaos-army", seed=s)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
        retried += sum(1 for e in tev
                       if e.kind == kind and retry_token_attempt(int(e.args[0])) > 0)
    # the ring holds every re-sent army row: the delivered ones, and the
    # suppressed ones and give-ups beside them
    assert retried >= int(to.met[:, MET_RETRY].sum())


# ------------------------------------------- the card's retry phases
def test_chip_smoke_holds_the_retry_soak_shapes():
    """chip_smoke.py's phases 51-54 run tools/retry_soak.py's plans,
    policies, configs, specs and workloads, and its pins script's; phase
    54's plan is the step goldens' kvchaos army scenario with the soak's
    kvchaos policy on its army."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "tools"))
    sys.path.insert(0, str(root))
    import chip_smoke
    import retry_soak
    import step_goldens

    import _torch_retry_pins as pins

    tplans = chip_smoke.retry_plans()
    assert tplans.keys() == pins.retry_plans(jchaos, jmodels).keys()
    for k, jp in pins.retry_plans(jchaos, jmodels).items():
        assert (tplans[k].hash(), tplans[k].name) == (jp.hash(), jp.name), k
        assert repr(tplans[k].retry_spec()) == repr(jp.retry_spec()), k
    quiet, gray = retry_soak.kv_plans()
    assert (quiet.hash(), gray.hash()) == (tplans["kv-quiet"].hash(), tplans["kv-gray"].hash())
    assert retry_soak.sk_plan("x").hash() == tplans["sk-hunt"].hash()
    assert (repr(retry_soak.KV_POLICY), repr(retry_soak.SK_POLICY)) == tuple(
        repr(p) for p in pins.policies(jchaos))
    assert tcore.EngineConfig(**chip_smoke.RETRY_KV_KW).hash() == retry_soak.KV_CFG.hash()
    assert tcore.EngineConfig(**chip_smoke.RETRY_SK_KW).hash() == retry_soak.SK_CFG.hash()
    assert dataclasses.astuple(tcore.LatencySpec(**chip_smoke.RETRY_KV_LAT)) == \
        dataclasses.astuple(retry_soak.LAT)
    assert dataclasses.astuple(tcore.LatencySpec(**chip_smoke.RETRY_SK_LAT)) == \
        dataclasses.astuple(retry_soak.SK_LAT)
    assert chip_smoke.RETRY_STEPS == retry_soak.KV_STEPS == retry_soak.SK_STEPS == pins.STEPS
    assert (chip_smoke.RETRY_KV_KW, chip_smoke.RETRY_SK_KW, chip_smoke.RETRY_OBS_KW) == (
        pins.KV_CFG_KW, pins.SK_CFG_KW, pins.OBS_CFG_KW)
    assert (chip_smoke.RETRY_OBS_LAT, chip_smoke.RETRY_OBS_STEPS) == (pins.OBS_LAT_KW,
                                                                       pins.OBS_STEPS)
    assert dict(chip_smoke.RETRY_OBS_TAPS, metrics=True) == pins.OBS_TAPS
    # phase 54's plan without the policy is the goldens' scenario's
    obs = tplans["kv-obs"]
    bare = FaultPlan((dataclasses.replace(obs.specs[0], retry=None), *obs.specs[1:]))
    _wl, jcfg, jplan, jlat = step_goldens.scenarios()["kvchaos/army-obs"]
    assert bare.hash() == jplan.hash()
    assert tcore.EngineConfig(**chip_smoke.RETRY_OBS_KW).hash() == jcfg.hash()
    # the workloads are the soak's
    want = {"kv": jmodels.make_kvchaos(writes=12, n_replicas=2, chaos=False, army=True,
                                       record=True),
            "sk": jmodels.make_shardkv(record=True, chaos=False, army=True),
            "noidem": jmodels.make_shardkv(record=True, chaos=False, army=True, bug="noidem"),
            "obs": jmodels.make_kvchaos(record=True, army=True, army_probes=2)}
    for k, wl in chip_smoke.retry_workloads().items():
        assert (wl.name, wl.n_nodes, wl.state_width, len(wl.handlers), wl.lat_markers) == (
            want[k].name, want[k].n_nodes, want[k].state_width, len(want[k].handlers),
            want[k].lat_markers), k
