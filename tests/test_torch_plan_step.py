"""Fault plans through the port's step, against the JAX engine and the
kernel's step code.

* The plain step under each fault spec's plan, and under a plan that
  mixes them all, with ``dup_rows`` off and on, equals the JAX engine
  (``make_run_while(layout="scatter", time32=False)``) per field, on
  kvchaos ``writes=5, chaos=False`` at pool 96, 64 seeds. The
  duplication lanes come before the user purposes: kvchaos-record with
  its own chaos (three user purposes) under duplication holds that.
* Handlers that emit the extended kinds themselves (``set_skew``,
  ``slow_link``, ``clog_link_one_way``, ``dup_on``) and read the skewed
  clock, in both packages.
* The errors: a pool too small for the plan rows, a missing plan, the
  oracle's refusal of a plan.
* The run kernel's step code built with g++ (``tests/_torch_host.py``):
  the chaos-plan libraries, with and without the duplication rows,
  equal the plain step per field under the nemesis soak's plans.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import madsim_tpu.chaos as jc
import madsim_tpu.engine as je
from madsim_tpu.models import make_kvchaos as j_kv
from madsim_tpu_torch import chaos as tc
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.engine.oracle import assert_plan_oracle_free, run_oracle
from madsim_tpu_torch.models import make_kvchaos as t_kv
from madsim_tpu_torch.models import make_paxos, make_raft, make_twophase

from _torch_host import build_host_kernel, host_run
from _torch_parity import assert_same_state
from test_torch_plan import plans

SEEDS = np.arange(64, dtype=np.uint64)
KV_KW = dict(pool_size=96, loss_p=0.02)  # tests/test_chaos.py's kv_cfg
CAP = 3000


@pytest.fixture(scope="module")
def kv_runs():
    """The JAX engine's jitted runs of kvchaos chaos=False, without and
    with the duplication rows, shared by every plan case."""
    wl, cfg = j_kv(writes=5, chaos=False), je.EngineConfig(**KV_KW)
    return {
        dup: jax.jit(je.make_run_while(wl, cfg, CAP, layout="scatter", time32=False,
                                       dup_rows=dup))
        for dup in (False, True)
    }


def _both(j_wl, t_wl, kw, jrun, plan_pair, seeds, dup, cap=CAP):
    """The JAX run and the port's plain run of one plan; equal per field."""
    jplan, tplan = plan_pair
    jcfg, tcfg = je.EngineConfig(**kw), tcore.EngineConfig(**kw)
    jst = je.make_init(j_wl, jcfg, time32=False, plan_slots=jplan.slots)(
        seeds, jplan.compile_batch(seeds))
    tst = tcore.make_init(t_wl, tcfg, device="cpu", plan_slots=tplan.slots)(
        seeds, tplan.compile_batch(seeds))
    want = jrun(jst)
    got = tcore.make_run_while_plain(t_wl, tcfg, cap, dup_rows=dup)(tst)
    assert_same_state(want, got)
    return state_to_numpy(got)


CASES = [(name, False) for name in plans(tc)] + [("dup", True), ("mixed", True)]


@pytest.mark.parametrize("name,dup", CASES, ids=[f"{n}-dup{int(d)}" for n, d in CASES])
def test_plain_step_under_a_plan_equals_the_reference(kv_runs, name, dup):
    got = _both(j_kv(writes=5, chaos=False), t_kv(writes=5, chaos=False), KV_KW,
                kv_runs[dup], (plans(jc)[name], plans(tc)[name]), SEEDS, dup)
    assert got["halted"].all()
    if name == "gray":
        assert (got["slow"] > 1).any()
    if name in ("skew", "mixed"):
        assert (got["skew"] != 0).any()
    if name in ("asymmetric", "flapping"):
        assert (got["clog"] != got["clog"].transpose(0, 2, 1)).any() or \
            (got["ev_meta"] >> 24).max() > 0


CHAOS_OFF = {
    # name -> (factory kwargs, engine kwargs, cap): the plan libraries'
    # variants, before any plan touches them
    "kvchaos-record": (dict(writes=5, record=True), dict(pool_size=96, loss_p=0.05), CAP),
    "kvchaos-bug": (dict(writes=5, record=True, bug=True), dict(pool_size=96, loss_p=0.05),
                    CAP),
    "paxos-record": (dict(record=True), dict(pool_size=96, loss_p=0.05), 4000),
    "twophase-record": (dict(record=True), dict(pool_size=96, loss_p=0.05), 4000),
}


@pytest.mark.parametrize("name", list(CHAOS_OFF))
def test_chaos_off_variants_equal_the_reference(name):
    import madsim_tpu.models as jm
    import madsim_tpu_torch.models as tm

    fkw, kw, cap = CHAOS_OFF[name]
    family = name.split("-")[0]
    jf, tf = getattr(jm, f"make_{family}"), getattr(tm, f"make_{family}")
    jw, tw = jf(chaos=False, **fkw), tf(chaos=False, **fkw)
    assert fused.workload_shape(tw) == fused.kernel_model(tw).shape
    seeds = SEEDS[:32]
    want = jax.jit(je.make_run_while(jw, je.EngineConfig(**kw), cap, layout="scatter",
                                     time32=False))(
        je.make_init(jw, je.EngineConfig(**kw), time32=False)(seeds))
    got = tcore.make_run_while_plain(tw, tcore.EngineConfig(**kw), cap)(
        tcore.make_init(tw, tcore.EngineConfig(**kw), device="cpu")(seeds))
    assert_same_state(want, got)
    assert bool(got.halted.all()) and int(got.hist_count.min()) > 0


def test_duplication_lanes_sit_below_the_user_purposes():
    """kvchaos-record with its own chaos draws three user purposes in
    on_init; under duplication their lanes sit past the K dup lanes."""
    kw = dict(pool_size=96, loss_p=0.05)
    jw, tw = j_kv(writes=5, record=True), t_kv(writes=5, record=True)
    assert tw.draw_purposes
    pair = (jc.FaultPlan((jc.Duplicate(t_min_ns=0, t_max_ns=1),)),
            tc.FaultPlan((tc.Duplicate(t_min_ns=0, t_max_ns=1),)))
    jrun = jax.jit(je.make_run_while(jw, je.EngineConfig(**kw), CAP, layout="scatter",
                                     time32=False, dup_rows=True))
    got = _both(jw, tw, kw, jrun, pair, SEEDS[:32], True)
    assert got["dup"].any() and got["hist_count"].min() > 0


def _probe_workloads():
    """One node per package whose handlers emit the extended kinds and
    record the clock they see: node 0 skews node 1 by 250 ms, slows its
    link to node 2 eight-fold, clogs 2 -> 1 one way, turns duplication
    on and opens two disk-fault windows; then each node probes its clock
    and pings the next."""
    def make(core, xp, set_col0, inc_col1):
        def on_init(ctx):
            eb = ctx.emits()
            first = ctx.node == 0
            eb.set_skew(1, 250_000_000, when=first)
            eb.slow_link(0, 2, 8, when=first)
            eb.clog_link_one_way(2, 1, when=first)
            eb.dup_on(when=first)
            # disk faults: no state to change without the sync discipline
            eb.sync_eio(1, when=first)
            eb.torn_on(-1, when=first)
            eb.after(10_000_000, core.user_kind(1), ctx.node)
            return ctx.state, eb.build()

        def on_probe(ctx):
            eb = ctx.emits()
            eb.send((ctx.node + 1) % 3, core.user_kind(2))
            eb.after(30_000_000, core.user_kind(1), ctx.node)
            return set_col0(ctx.state, (ctx.now // 1_000_000).astype(xp.int32)
                            if xp is jnp else (ctx.now // 1_000_000).to(torch.int32)), eb.build()

        def on_ping(ctx):
            eb = ctx.emits()
            eb.unslow_link(0, 2, when=ctx.node == 2)
            return inc_col1(ctx.state), eb.build()

        return core.Workload(name="ext-probe", n_nodes=3, state_width=2,
                             handlers=(on_init, on_probe, on_ping), max_emits=7)

    jw = make(je, jnp, lambda st, v: st.at[0].set(v), lambda st: st.at[1].add(1))

    def t_set0(st, v):
        return tcore.set_cols(st, torch.ones_like(v, dtype=torch.bool), {0: v})

    def t_inc1(st):
        return tcore.set_cols(st, torch.ones(st.shape[0], dtype=torch.bool), {1: st[:, 1] + 1})

    return jw, make(tcore, torch, t_set0, t_inc1)


@pytest.mark.parametrize("dup", [False, True])
def test_handler_emitted_chaos_and_the_skewed_clock(dup):
    jw, tw = _probe_workloads()
    kw = dict(pool_size=32, loss_p=0.1)
    seeds = SEEDS[:16]
    jst = je.make_init(jw, je.EngineConfig(**kw), time32=False)(seeds)
    want = jax.jit(je.make_run(jw, je.EngineConfig(**kw), 120, layout="scatter",
                               time32=False, dup_rows=dup))(jst)
    got = tcore.make_run_plain(tw, tcore.EngineConfig(**kw), 120, dup_rows=dup)(
        tcore.make_init(tw, tcore.EngineConfig(**kw), device="cpu")(seeds))
    assert_same_state(want, got)
    g = state_to_numpy(got)
    assert (g["skew"][:, 1] == 250_000_000).all() and g["clog"][:, 2, 1].all()
    assert not g["clog"][:, 1, 2].any() and g["dup"].all()
    # node 1's probes read its clock 250 ms ahead of node 0's
    assert (g["node_state"][:, 1, 0] - g["node_state"][:, 0, 0] >= 200).all()


def test_plan_errors():
    wl = t_kv(writes=5, chaos=False)
    with pytest.raises(ValueError, match="fault-plan rows"):
        tcore.make_init(wl, tcore.EngineConfig(pool_size=8), device="cpu", plan_slots=6)
    init = tcore.make_init(wl, tcore.EngineConfig(**KV_KW), device="cpu", plan_slots=2)
    with pytest.raises(ValueError, match="pass the compiled PlanRows"):
        init(SEEDS[:2])
    rows = tc.FaultPlan((tc.Duplicate(),)).compile_batch(SEEDS[:3])
    with pytest.raises(ValueError, match="plan_slots=2 need"):
        init(SEEDS[:2], rows)
    # a PlanRows without node targets node 0
    st = init(SEEDS[:3], dataclasses.replace(rows, node=None))
    assert ((st.ev_meta[:, 6:8] >> 8) & 0xFF).eq(1).all()
    plan = plans(tc)["gray"]
    with pytest.raises(ValueError, match="extended chaos kinds"):
        assert_plan_oracle_free(plan)
    with pytest.raises(ValueError, match="takes no fault plan"):
        run_oracle(make_raft(), tcore.EngineConfig(pool_size=40), 0, 10,
                   plan=plans(tc)["crash"])


# ---------------------------------------------------------------------------
# the kernel's step code, built with g++, under the nemesis soak's plans
# ---------------------------------------------------------------------------

KV_PLAN = tc.FaultPlan((tc.CrashStorm(
    targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
    down_min_ns=50_000_000, down_max_ns=250_000_000),), name="kv-nemesis")
RAFT_EL_PLAN = tc.FaultPlan((
    tc.PauseStorm(targets=(0, 1, 2, 3, 4), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
                  down_min_ns=50_000_000, down_max_ns=300_000_000),
    tc.GrayFailure(targets=(0, 1, 2, 3, 4), n_links=2, t_min_ns=20_000_000,
                   t_max_ns=400_000_000, dur_min_ns=50_000_000, dur_max_ns=300_000_000,
                   mult_min=4, mult_max=16),
), name="raft-election-nemesis")
PAXOS_PLAN = tc.FaultPlan((
    tc.CrashStorm(targets=(5, 6, 7), n=2, t_min_ns=30_000_000, t_max_ns=200_000_000,
                  down_min_ns=80_000_000, down_max_ns=300_000_000),
    tc.GrayFailure(targets=tuple(range(8)), n_links=2, t_min_ns=10_000_000,
                   t_max_ns=200_000_000, dur_min_ns=50_000_000, dur_max_ns=200_000_000,
                   mult_min=4, mult_max=16),
), name="paxos-nemesis")
TP_PLAN = tc.FaultPlan((
    tc.CrashStorm(targets=(1, 2, 3, 4), n=1, t_min_ns=20_000_000, t_max_ns=250_000_000,
                  down_min_ns=100_000_000, down_max_ns=400_000_000),
    tc.Duplicate(t_min_ns=10_000_000, t_max_ns=300_000_000, dur_min_ns=50_000_000,
                 dur_max_ns=300_000_000),
), name="twophase-nemesis")

# library key -> (workload, engine kwargs, plan, dup_rows, cap)
HOST_CASES = {
    "kvchaos-bug-nochaos": (
        lambda: t_kv(writes=5, record=True, bug=True, chaos=False),
        dict(pool_size=96, loss_p=0.05), KV_PLAN, False, CAP),
    "kvchaos-record-nochaos-dup": (
        lambda: t_kv(writes=5, record=True, chaos=False), dict(pool_size=192, loss_p=0.05),
        plans(tc)["mixed"], True, CAP),
    "raft-record": (lambda: make_raft(record=True), dict(pool_size=64, loss_p=0.02),
                    RAFT_EL_PLAN, False, 2000),
    "paxos-record-nochaos": (lambda: make_paxos(record=True, chaos=False),
                             dict(pool_size=96, loss_p=0.05), PAXOS_PLAN, False, 4000),
    # the duplication plan on the library without the rows: the flag is
    # set and stored, and no shadow row is sent
    "twophase-record-nochaos": (lambda: make_twophase(record=True, chaos=False),
                                dict(pool_size=96, loss_p=0.05), TP_PLAN, False, 4000),
    "twophase-record-nochaos-dup": (lambda: make_twophase(record=True, chaos=False),
                                    dict(pool_size=96, loss_p=0.05), TP_PLAN, True, 4000),
}


@pytest.mark.parametrize("key", list(HOST_CASES))
def test_host_built_kernel_under_a_plan(tmp_path_factory, key):
    make, kw, plan, dup, cap = HOST_CASES[key]
    wl, cfg = make(), tcore.EngineConfig(**kw)
    spec = fused.kernel_model(wl, dup)
    assert spec.key == key and spec.dup == dup and kw["pool_size"] in spec.pools
    lib = build_host_kernel(tmp_path_factory.mktemp(key), spec, (kw["pool_size"],))
    seeds = SEEDS[:32]
    st = tcore.make_init(wl, cfg, device="cpu", plan_slots=plan.slots)(
        seeds, plan.compile_batch(seeds, wl=wl))
    want = state_to_numpy(tcore.make_run_while_plain(wl, cfg, cap, dup_rows=dup)(st))
    got = state_to_numpy(host_run(lib, wl, cfg, st, cap, True))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert want["hist_count"].min() > 0
    # duplication on top of the mixed plan's partitions can fill a pool
    assert dup or want["overflow"].sum() == 0
    if plan.uses_dup():
        assert want["dup"].any() or (want["ev_meta"] & 0xFF == tcore.KIND_DUP_OFF).any()


def test_host_built_dup_lanes_with_user_purposes(tmp_path_factory):
    """The kernel's draw order under duplication with user purposes:
    kvchaos-record (chaos on) built with the shadow rows."""
    spec = dataclasses.replace(fused.MODELS["kvchaos-record"], key="kvchaos-record-duptest",
                               dup=True)
    lib = build_host_kernel(tmp_path_factory.mktemp("duplanes"), spec, (96,))
    wl, cfg = t_kv(writes=5, record=True), tcore.EngineConfig(pool_size=96, loss_p=0.05)
    plan = plans(tc)["mixed"]
    seeds = SEEDS[:32]
    st = tcore.make_init(wl, cfg, device="cpu", plan_slots=plan.slots)(
        seeds, plan.compile_batch(seeds))
    want = state_to_numpy(tcore.make_run_while_plain(wl, cfg, CAP, dup_rows=True)(st))
    got = state_to_numpy(host_run(lib, wl, cfg, st, CAP, True))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_the_registry_refuses_what_it_does_not_build():
    """A dup run of a library registered without the rows, and a plan
    variant off the registry, derive their own libraries (neither runs
    the plain step)."""
    for wl, dup, key in (
        (make_raft(), True, "raft-dup"),
        (make_paxos(record=True, chaos=False), True, "paxos-record-nochaos-dup"),
        (__import__("madsim_tpu_torch.models", fromlist=["x"]).make_raftlog(chaos=False),
         False, "raftlog-nochaos"),
    ):
        spec = fused.kernel_model(wl, dup_rows=dup)
        assert spec.key == key and spec.dup == dup and spec.key not in fused.MODELS
        assert ("DupRows" in spec.unit_source()) == dup
    plan_libs = {k: m for k, m in fused.MODELS.items() if ("chaos", False) in m.fixed}
    assert sorted(plan_libs) == sorted(HOST_CASES.keys() - {"raft-record"}
                                       | {"kvchaos-record-nochaos", "raftlog-durable-record",
                                          "raftlog-nosync-record", "kvchaos-army-nochaos",
                                          "shardkv-record-army-nochaos", "kvchaos-bug-nochaos-dup",
                                          "raftlog-record-w16-nochaos",
                                          "kvchaos-record-army-r2-nochaos",
                                          "shardkv-noidem-army-nochaos",
                                          "raftlog-record-nochaos",
                                          "leasekv-record-nochaos"})
    for key, spec in fused.MODELS.items():
        assert key.startswith(spec.name) or (key, spec.name) in (
            ("raft", "raft-election"), ("raft-record", "raft-election-record"),
            ("raftlog-durable-record", "raftlog-record"))
        assert ("#define MADSIM_MODEL" in spec.unit_source()
                and ("DupRows" in spec.unit_source()) == spec.dup)
        assert not spec.dup or key in plan_libs


def test_sweep_takes_plan_rows():
    from madsim_tpu_torch.engine.search import make_sweep

    wl, cfg = t_kv(writes=5, chaos=False), tcore.EngineConfig(**KV_KW)
    plan, seeds = plans(tc)["dup"], SEEDS[:8]
    rows = plan.compile_batch(seeds)
    view = make_sweep(wl, cfg, CAP, device="cpu", plan_slots=plan.slots, dup_rows=True)(
        seeds, rows)
    want = tcore.make_run_while_plain(wl, cfg, CAP, dup_rows=True)(
        tcore.make_init(wl, cfg, device="cpu", plan_slots=plan.slots)(seeds, rows))
    for f, v in view.items():
        assert v.equal(getattr(want, f)), f
    assert bool(view["dup"].any() or (view["msg_count"] > 0).all())
