"""Shared helper of the port's client-retry tests: the plans of the JAX
package's ``tests/test_retry.py`` and ``tools/retry_soak.py`` built with
either package's ``chaos`` and ``models`` modules, and one run of the
same seeds under a plan pair through the JAX engine (CPU, scatter
layout, int64 times) and the port's plain step, each with its own
package's ``RetrySpec`` of the plan, every field compared (the three
retry columns and all 18 ``met`` slots included)."""

import _torch_threads  # noqa: F401

import numpy as np

import jax

import madsim_tpu.chaos as jchaos
import madsim_tpu.engine as je
import madsim_tpu.models as jmodels
import madsim_tpu_torch.models as tmodels
from madsim_tpu_torch import chaos as tchaos
from madsim_tpu_torch.engine import core as tcore

from _torch_parity import assert_same_state

# tests/test_retry.py's pinned shape: the 2-replica kvchaos army under a
# gray-failure slow link, a 50 ms response deadline
N_OPS = 16
CFG_KW = dict(pool_size=64, time_limit_ns=450_000_000, clog_backoff_max_ns=2_000_000_000)
SPEC_KW = dict(ops=N_OPS, phases=3, phase_ns=1 << 27)
STEPS = 1500
KV_MAKE = dict(writes=12, n_replicas=2, chaos=False, army=True)
# tools/retry_soak.py's shardkv policy, plan and config
SK_CFG_KW = dict(pool_size=96, time_limit_ns=600_000_000)
SK_MAKE = dict(record=True, chaos=False, army=True)


def kv_policy(ch):
    return ch.RetryPolicy(timeout_ns=50_000_000, max_attempts=3, backoff_base_ns=10_000_000,
                          backoff_mult=2.0, jitter=0.5)


def sk_policy(ch):
    return ch.RetryPolicy(timeout_ns=8_000_000, max_attempts=3, backoff_base_ns=4_000_000,
                          backoff_mult=2.0, jitter=0.25)


def pkg(port: bool):
    """``(chaos, models)`` of the port or the JAX package."""
    return (tchaos, tmodels) if port else (jchaos, jmodels)


def kv_plan(port: bool, policy=True, gray=True, name="retry-pin"):
    """test_retry.py's plan: the kvchaos army (with the policy when
    ``policy``) and, when ``gray``, its slow link."""
    ch, m = pkg(port)
    army = m.kvchaos.client_army(n_ops=N_OPS, t_min_ns=5_000_000, t_max_ns=280_000_000,
                                 n_replicas=2, retry=kv_policy(ch) if policy else None)
    specs = (army, ch.GrayFailure(targets=(0, 3), n_links=1, mult_min=6, mult_max=12))
    return ch.FaultPlan(specs if gray else specs[:1], name=name)


def sk_plan(port: bool, name="noidem-hunt"):
    """The retry soak's shardkv plan: the policied army and its slow link."""
    ch, m = pkg(port)
    return ch.FaultPlan(
        (m.shardkv.client_army(n_ops=N_OPS, t_min_ns=5_000_000, t_max_ns=280_000_000,
                               retry=sk_policy(ch)),
         ch.GrayFailure(targets=(0, 1), n_links=1, mult_min=8, mult_max=16)),
        name=name,
    )


def run_both(jwl, twl, jplan, tplan, kw, seeds, n_steps, lat=None, until_halted=True,
             **taps):
    """``seeds`` under the plan pair through both engines with each
    plan's ``retry_spec()`` and ``taps``, ``lat`` the ``LatencySpec``
    keyword arguments; asserts every field equal (the initial states
    too) and returns ``(JAX final state, port final state)``."""
    assert jplan.hash() == tplan.hash()
    jcfg, tcfg = je.EngineConfig(**kw), tcore.EngineConfig(**kw)
    jlat = je.LatencySpec(**lat) if lat else None
    tlat = tcore.LatencySpec(**lat) if lat else None
    jrt, trt = jplan.retry_spec(), tplan.retry_spec()
    assert repr(jrt) == repr(trt)
    js = je.make_init(jwl, jcfg, plan_slots=jplan.slots, latency=jlat, retry=jrt,
                      time32=False, **taps)(seeds, jplan.compile_batch(seeds, wl=jwl))
    ts = tcore.make_init(twl, tcfg, device="cpu", plan_slots=tplan.slots, latency=tlat,
                         retry=trt, **taps)(seeds, tplan.compile_batch(seeds, wl=twl))
    assert_same_state(js, ts)
    jmake = je.make_run_while if until_halted else je.make_run
    tmake = tcore.make_run_while if until_halted else tcore.make_run
    jo = jax.jit(jmake(jwl, jcfg, n_steps, layout="scatter", time32=False, latency=jlat,
                       retry=jrt, **taps))(js)
    to = tmake(twl, tcfg, n_steps, latency=tlat, retry=trt, **taps)(ts)
    assert_same_state(jo, to)
    return jo, to


def seeds_of(n):
    return np.arange(n, dtype=np.uint64)
