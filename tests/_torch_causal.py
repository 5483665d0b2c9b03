"""Shared helper of the port's causal tests: the fault plans of
``tools/causal_soak.py`` built with either package's ``chaos`` module,
and one capture of the same seeds under a plan through the JAX engine
(CPU, scatter layout, int64 times) and the port's plain step, every
field compared, the six causal columns included."""

import _torch_threads  # noqa: F401

import numpy as np

import jax

import madsim_tpu.engine as je
from madsim_tpu_torch.engine import core as tcore

from _torch_parity import assert_same_state

KV_KW = dict(pool_size=192, loss_p=0.05)
HUNT_KW = dict(pool_size=192, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)


def kv_plan(m):
    """The soak's crash storm over kvchaos's replicas."""
    return m.FaultPlan((m.CrashStorm(
        targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
        down_min_ns=50_000_000, down_max_ns=250_000_000),), name="kv-nemesis")


def hunt_plan(m):
    """The soak's cone hunt: a crash storm and a flapping partition over
    raftlog's five servers."""
    nodes = (0, 1, 2, 3, 4)
    return m.FaultPlan((
        m.CrashStorm(targets=nodes, n=2, t_min_ns=150_000_000, t_max_ns=500_000_000,
                     down_min_ns=100_000_000, down_max_ns=400_000_000),
        m.FlappingPartition(targets=nodes, n_cycles=2, t_min_ns=50_000_000,
                            t_max_ns=400_000_000, dur_min_ns=100_000_000,
                            dur_max_ns=300_000_000, up_min_ns=20_000_000,
                            up_max_ns=200_000_000),
    ), name="raftlog-cone-hunt")


def arrow_plan(m):
    """The soak's arrow confuser: duplicated messages and slowed links."""
    return m.FaultPlan((
        m.Duplicate(t_min_ns=20_000_000, t_max_ns=600_000_000, dur_min_ns=100_000_000,
                    dur_max_ns=500_000_000),
        m.GrayFailure(targets=(0, 1, 2, 3, 4), n_links=2, t_min_ns=20_000_000,
                      t_max_ns=600_000_000, dur_min_ns=100_000_000,
                      dur_max_ns=500_000_000, mult_min=8, mult_max=32),
    ), name="dup-slowlink")


def capture_both(jwl, twl, jplan, tplan, kw, seeds, n_steps, **taps):
    """``seeds`` under the plan pair (either may be None) through both
    engines' ``make_run_while`` with ``taps`` (``causal`` among them);
    asserts every field equal and returns ``(JAX final state, port final
    state)``."""
    jcfg, tcfg = je.EngineConfig(**kw), tcore.EngineConfig(**kw)
    dup = bool(tplan is not None and tplan.uses_dup())
    if tplan is None:
        js = je.make_init(jwl, jcfg, time32=False, **taps)(seeds)
        ts = tcore.make_init(twl, tcfg, device="cpu", **taps)(seeds)
    else:
        js = je.make_init(jwl, jcfg, time32=False, plan_slots=jplan.slots, **taps)(
            seeds, jplan.compile_batch(seeds, wl=jwl))
        ts = tcore.make_init(twl, tcfg, device="cpu", plan_slots=tplan.slots, **taps)(
            seeds, tplan.compile_batch(seeds, wl=twl))
    assert_same_state(js, ts)
    jo = jax.jit(je.make_run_while(jwl, jcfg, n_steps, layout="scatter", time32=False,
                                   dup_rows=dup, **taps))(js)
    to = tcore.make_run_while(twl, tcfg, n_steps, dup_rows=dup, **taps)(ts)
    assert_same_state(jo, to)
    return jo, to


def seeds_of(n, stride=1):
    return np.arange(n, dtype=np.uint64) * np.uint64(stride)
