"""The coverage taps and the timeline ring in the port's plain step and
the run kernel's step code, against the JAX package.

* The plain step with ``cov_words``, ``cov_hitcount`` and
  ``timeline_cap`` equals the JAX engine
  (``make_run_while(layout="scatter", time32=False)``) per field, every
  new column included: raft with all three taps; kvchaos-record-bug
  under a nemesis plan with duplication and flapping partitions
  (``dup_rows``: the emit-time sidecar through shadow rows and clog
  reschedules); leasekv and shardkv with their default coverage hooks;
  raftlog ``durable=True, cov_spread=True`` under a disk-fault plan; a
  ring that overflows; and ``cov_words=1`` with hit counts on a ticking
  workload, where bits collide and counters saturate at 255.
* The taps change no trajectory: every other field equals the run
  without them.
* The build parameters are validated like the reference's, and a step
  refuses a state built with other widths.
* The run kernel's step code built with g++ (``tests/_torch_host.py``):
  the obs build equals the plain step per field, with the taps on and
  off, for the duplication library under the nemesis plan and for
  raftlog ``cov_spread``.

Exact equality throughout (the engine is integer arithmetic).
"""

import numpy as np
import pytest

import jax

import madsim_tpu.chaos as jc
import madsim_tpu.engine as je
import madsim_tpu.models as jm
import madsim_tpu_torch.models as tm
from madsim_tpu_torch import chaos as tc
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy

from _torch_host import build_host_kernel, host_run
from _torch_parity import assert_same_state

SEEDS = np.arange(8, dtype=np.uint64)
ALL_TAPS = dict(cov_words=64, cov_hitcount=True, timeline_cap=256)


def kv_plan(m):
    """The kv nemesis plan of tests/test_chaos.py, with a duplication
    window and flapping partitions on top."""
    return m.FaultPlan((
        m.CrashStorm(targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
                     down_min_ns=50_000_000, down_max_ns=300_000_000),
        m.Duplicate(t_min_ns=10_000_000, t_max_ns=300_000_000, dur_min_ns=50_000_000,
                    dur_max_ns=300_000_000),
        m.FlappingPartition(targets=(0, 1, 2, 3), n_cycles=2, t_min_ns=10_000_000,
                            t_max_ns=100_000_000, dur_min_ns=50_000_000,
                            dur_max_ns=200_000_000, up_min_ns=10_000_000,
                            up_max_ns=50_000_000),
    ), name="kv-obs")


def disk_plan(m):
    """A crash storm with torn writes, a lying disk and an EIO window on
    raftlog's five nodes."""
    nodes = (0, 1, 2, 3, 4)
    return m.FaultPlan((
        m.CrashStorm(targets=nodes, n=2, t_min_ns=150_000_000, t_max_ns=500_000_000,
                     down_min_ns=100_000_000, down_max_ns=400_000_000),
        m.DiskFault(targets=nodes, n_torn=2, n_sync_loss=1, n_eio=1,
                    t_min_ns=50_000_000, t_max_ns=500_000_000),
    ), name="disk-obs")


def tick(m):
    """Two nodes: node 0 ticks every nanosecond and messages node 1, so
    the same few features recur on every dispatch (both packages)."""
    def on_init(ctx):
        eb = ctx.emits()
        eb.after(1, m.user_kind(1), 0, when=ctx.node == 0)
        return ctx.state, eb.build()

    def on_tick(ctx):
        eb = ctx.emits()
        eb.after(1, m.user_kind(1), 0)
        eb.send(1, m.user_kind(2))
        return ctx.state, eb.build()

    def on_msg(ctx):
        return ctx.state, ctx.emits().build()

    return m.Workload(name="tick", n_nodes=2, state_width=1,
                      handlers=(on_init, on_tick, on_msg), max_emits=2)


# case -> (workload in module m, engine kwargs, plan in module m or None,
# dup_rows, step cap, taps)
CASES = {
    "raft": (lambda m: m.make_raft(), dict(pool_size=40, loss_p=0.02), None, False, 600,
             ALL_TAPS),
    "kvchaos-bug-dup": (lambda m: m.make_kvchaos(writes=5, record=True, bug=True, chaos=False),
                        dict(pool_size=96, loss_p=0.02), kv_plan, True, 3000,
                        dict(ALL_TAPS, timeline_cap=512)),
    "leasekv": (lambda m: m.make_leasekv(), dict(pool_size=48, loss_p=0.02), None, False,
                3000, dict(cov_words=64, cov_hitcount=True, timeline_cap=0)),
    "shardkv": (lambda m: m.make_shardkv(), dict(pool_size=64, loss_p=0.02), None, False,
                3000, dict(cov_words=64, cov_hitcount=False, timeline_cap=0)),
    "raftlog-spread": (lambda m: m.make_raftlog(durable=True, cov_spread=True),
                       dict(pool_size=64, loss_p=0.02), disk_plan, False, 4000,
                       dict(ALL_TAPS, timeline_cap=128)),
    "raft-ring-overflow": (lambda m: m.make_raft(), dict(pool_size=40, loss_p=0.02), None,
                           False, 600, dict(cov_words=0, cov_hitcount=False, timeline_cap=12)),
    "tick-cw1": (tick, dict(pool_size=8), None, False, 700,
                 dict(cov_words=1, cov_hitcount=True, timeline_cap=0)),
}


def _init(case, core, models, chaos, taps, seeds=SEEDS):
    make, kw, plan, _dup, _cap, _taps = CASES[case]
    wl = make(models)
    cfg = core.EngineConfig(**kw)
    p = plan(chaos) if plan else None
    kwargs = dict(plan_slots=p.slots if p else 0, **taps)
    if core is je:
        init = je.make_init(wl, cfg, time32=False, **kwargs)
    else:
        init = tcore.make_init(wl, cfg, device="cpu", **kwargs)
    return wl, cfg, init(seeds, p.compile_batch(seeds, wl=wl)) if p else init(seeds)


class _Both:
    """The engine entry points and the factories of one package, where
    the tick workload reads user_kind and Workload."""

    def __init__(self, core, models):
        self.core, self.models = core, models

    def __getattr__(self, name):
        if hasattr(self.models, name):
            return getattr(self.models, name)
        return getattr(self.core, name)


J, T = _Both(je, jm), _Both(tcore, tm)


def run_plain(case, taps=None):
    _make, _kw, _plan, dup, cap, case_taps = CASES[case]
    taps = case_taps if taps is None else taps
    wl, cfg, st = _init(case, tcore, T, tc, taps)
    return tcore.make_run_while_plain(wl, cfg, cap, dup_rows=dup, **taps)(st)


@pytest.mark.parametrize("case", list(CASES))
def test_taps_equal_the_reference(case):
    _make, _kw, _plan, dup, cap, taps = CASES[case]
    jwl, jcfg, jst = _init(case, je, J, jc, taps)
    want = jax.jit(je.make_run_while(jwl, jcfg, cap, layout="scatter", time32=False,
                                     dup_rows=dup, **taps))(jst)
    got = run_plain(case)
    assert_same_state(want, got)
    g = state_to_numpy(got)
    cw, hc, tcap = taps["cov_words"], taps["cov_hitcount"], taps["timeline_cap"]
    assert g["cov"].shape == (len(SEEDS), cw) and g["tl_t"].shape == (len(SEEDS), tcap)
    if cw:
        assert g["cov"].any(1).all() and g["cov_last"].shape == (len(SEEDS), g["alive"].shape[1])
    if hc:
        assert g["cov_hits"].shape == (len(SEEDS), cw * 32)
    if case == "raft-ring-overflow":
        assert (g["tl_drop"] > 0).any() and (g["tl_count"] <= tcap).all()
    elif tcap:
        assert g["tl_drop"].sum() == 0 and (g["tl_count"] > 0).all()
    if case == "kvchaos-bug-dup":
        # shadow rows were placed and clog-held rows rescheduled
        assert g["dup"].any() or (g["ev_meta"] & 0xFF == tcore.KIND_DUP_OFF).any()
        assert (g["ev_meta"] >> 24).any() and (g["tl_meta"] >> 24).any()
    if case == "tick-cw1":
        # 32 bit positions: the counters saturate, and features collide
        assert (g["cov_hits"].max(1) == 255).all()
        assert (np.unpackbits(g["cov"].view(np.uint8), axis=1).sum(1) < 32).all()


@pytest.mark.parametrize("case", ["raft", "kvchaos-bug-dup"])
def test_taps_change_no_trajectory(case):
    off = dict(cov_words=0, cov_hitcount=False, timeline_cap=0)
    on, plain = run_plain(case), run_plain(case, off)
    for f in tcore.STATE_FIELDS:
        if f not in tcore.OBS_FIELDS:
            assert getattr(on, f).equal(getattr(plain, f)), f
    for f in tcore.OBS_FIELDS:
        assert getattr(plain, f).numel() == 0 or not getattr(plain, f).any(), f


def test_build_parameters_are_validated_like_the_reference():
    wl, cfg = tm.make_raft(), tcore.EngineConfig(pool_size=40)
    for kw, msg in ((dict(cov_words=3), "power of two"),
                    (dict(cov_hitcount=True), "needs coverage enabled"),
                    (dict(timeline_cap=-1), "must be >= 0")):
        with pytest.raises(ValueError, match=msg):
            tcore.make_init(wl, cfg, device="cpu", **kw)
        with pytest.raises(ValueError, match=msg):
            tcore.make_step_plain(wl, cfg, **kw)
        with pytest.raises(ValueError, match=msg):
            je.make_init(jm.make_raft(), je.EngineConfig(pool_size=40), **kw)
    st = tcore.make_init(wl, cfg, device="cpu", cov_words=4)(SEEDS[:2])
    with pytest.raises(ValueError, match="same arguments"):
        tcore.make_step_plain(wl, cfg, cov_words=8)(st)
    with pytest.raises(ValueError, match="same arguments"):
        fused.check_taps(st, False, cov_words=4, timeline_cap=16)
    fused.check_taps(st, False, cov_words=4)
    assert fused.obs_words(st) == (4, 0, 0)
    assert {"cov", "cov_last", "cov_hits"}.isdisjoint(fused._unwritten(st))
    assert set(fused.RING_FIELDS) <= set(fused._unwritten(st))
    assert fused.has_obs(st) and not fused.has_obs(
        tcore.make_init(wl, cfg, device="cpu")(SEEDS[:2]))


def test_the_hooks_are_the_reference_workloads():
    """leasekv and shardkv carry their coverage hooks by default, raftlog
    with cov_spread, and each is its trait's in the kernel library."""
    for make, key in ((tm.make_leasekv, "leasekv"), (tm.make_shardkv, "shardkv")):
        assert make().cov_features is not None and fused.kernel_model(make()).key == key
    spread = tm.make_raftlog(durable=True, cov_spread=True)
    assert fused.kernel_model(spread).key == "raftlog-durable-spread"
    assert fused.kernel_model(tm.make_raftlog(durable=True)).key == "raftlog-durable"
    assert fused.kernel_model(tm.make_raftlog(cov_spread=True)).key == "raftlog-spread"
    # the registered kernels with the taps are built at the listed pools;
    # at any other pool the launch builds the library with them
    assert {k: m.obs_pools for k, m in fused.MODELS.items() if m.obs_pools} == {
        "raft": (40, 64), "leasekv": (48,), "shardkv": (64,), "kvchaos-bug-nochaos": (192,),
        "raftlog-durable-spread": (64,), "kvchaos-record-army": (72,),
        "raftlog-record-army": (96,), "kvchaos-bug-nochaos-dup": (192,),
        "raftlog-record-w16-nochaos": (192,), "shardkv-noidem-army-nochaos": (96,),
        "raftlog-record-nochaos": (128,), "raftlog-nosync-record": (128,),
        "kvchaos-army-nochaos": (160,)}
    raft = tm.make_raft()
    for pool, taps, key in ((128, dict(cov_words=2), "raft-p128-obs"), (40, {}, "raft")):
        st = tcore.make_init(raft, tcore.EngineConfig(pool_size=pool), device="cpu", **taps)(
            SEEDS[:2])
        with pytest.raises(ValueError, match="CUDA"):
            fused.check_state(fused.MODELS["raft"], raft, st)
        assert fused.library_at(fused.MODELS["raft"], pool, fused.state_taps(st)).key == key


# host case -> (plain case, library key)
HOST_CASES = {
    "kvchaos-record-nochaos-dup": "kvchaos-bug-dup",
    "raftlog-durable-spread": "raftlog-spread",
}


@pytest.mark.parametrize("key", list(HOST_CASES))
def test_host_built_obs_kernel_equals_the_plain_step(tmp_path_factory, key):
    case = HOST_CASES[key]
    make, kw, plan, dup, cap, taps = CASES[case]
    if key == "kvchaos-record-nochaos-dup":
        # the duplication library is the record variant's
        make = lambda m: m.make_kvchaos(writes=5, record=True, chaos=False)  # noqa: E731
    wl, cfg = make(tm), tcore.EngineConfig(**kw)
    spec = fused.kernel_model(wl, dup)
    assert spec.key == key
    lib = build_host_kernel(tmp_path_factory.mktemp(key), spec, (kw["pool_size"],), obs=True)
    p = plan(tc)
    for t in (taps, dict(cov_words=0, cov_hitcount=False, timeline_cap=0),
              dict(cov_words=2, cov_hitcount=False, timeline_cap=16)):
        st = tcore.make_init(wl, cfg, device="cpu", plan_slots=p.slots, **t)(
            SEEDS, p.compile_batch(SEEDS, wl=wl))
        want = state_to_numpy(tcore.make_run_while_plain(wl, cfg, cap, dup_rows=dup, **t)(st))
        got = state_to_numpy(host_run(lib, wl, cfg, st, cap, True))
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=f"{t} {name}")
        assert (want["tl_drop"] > 0).any() == (t["timeline_cap"] == 16)
