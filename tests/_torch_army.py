"""Shared helper of the port's latency and client-army tests: one plan
compiled by both packages, and the same seeds run through the JAX
engine (CPU, scatter layout, int64 times) and the port's plain step
under it, every field compared."""

import _torch_threads  # noqa: F401

import numpy as np

import jax

import madsim_tpu.chaos as jchaos
import madsim_tpu.engine as je
import madsim_tpu.models as jmodels
import madsim_tpu_torch.models as tmodels
from madsim_tpu_torch import chaos as tchaos
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.convert import state_to_numpy

from _torch_parity import assert_same_state

CFG_KW = dict(loss_p=0.02, clog_backoff_max_ns=2_000_000_000)


def plan_pair(jmod, tmod, army_kw, *others):
    """The same ``FaultPlan`` in both packages: the model's client army
    (``client_army(**army_kw)``) and the ``(spec name, kwargs)`` fault
    specs after it. Their hashes are equal."""
    jplan = jchaos.FaultPlan((jmod.client_army(**army_kw),
                              *(getattr(jchaos, n)(**kw) for n, kw in others)))
    tplan = tchaos.FaultPlan((tmod.client_army(**army_kw),
                              *(getattr(tchaos, n)(**kw) for n, kw in others)))
    assert jplan.hash() == tplan.hash()
    return jplan, tplan


def init_both(jwl, twl, jplan, tplan, kw, seeds, lat=None, **taps):
    """Both packages' initial states under the plan (``lat``: the
    ``LatencySpec`` keyword arguments), held equal per field."""
    jcfg, tcfg = je.EngineConfig(**kw), tcore.EngineConfig(**kw)
    jlat = je.LatencySpec(**lat) if lat else None
    tlat = tcore.LatencySpec(**lat) if lat else None
    jrows, trows = jplan.compile_batch(seeds, wl=jwl), tplan.compile_batch(seeds, wl=twl)
    for f in ("time", "kind", "args", "valid", "node"):
        np.testing.assert_array_equal(getattr(trows, f), np.asarray(getattr(jrows, f)), f)
    js = je.make_init(jwl, jcfg, plan_slots=jplan.slots, latency=jlat, time32=False,
                      **taps)(seeds, jrows)
    ts = tcore.make_init(twl, tcfg, device="cpu", plan_slots=tplan.slots, latency=tlat,
                         **taps)(seeds, trows)
    assert_same_state(js, ts)
    return (jcfg, jlat, js), (tcfg, tlat, ts)


def run_plan_both(jwl, twl, jplan, tplan, kw, seeds, n_steps, lat=None,
                  until_halted=False, **taps):
    """The seeds under the plan through both engines; asserts every field
    equal and returns the port's final state as numpy."""
    (jcfg, jlat, js), (tcfg, tlat, ts) = init_both(jwl, twl, jplan, tplan, kw, seeds, lat,
                                                   **taps)
    jmake = je.make_run_while if until_halted else je.make_run
    tmake = tcore.make_run_while if until_halted else tcore.make_run
    jo = jax.jit(jmake(jwl, jcfg, n_steps, layout="scatter", time32=False, latency=jlat,
                       **taps))(js)
    to = tmake(twl, tcfg, n_steps, latency=tlat, **taps)(ts)
    assert_same_state(jo, to)
    return state_to_numpy(to)


def army_only_both(name, make_kw, n_ops, pool, n_steps, seeds):
    """The ``name`` model built with ``make_kw`` in both packages, run
    under its client army alone (``n_ops`` ops over 5-300 ms) with the
    latency tap; every field equal. Returns the port's state as numpy."""
    jmod, tmod = getattr(jmodels, name), getattr(tmodels, name)
    jwl = getattr(jmod, f"make_{name}")(**make_kw)
    twl = getattr(tmod, f"make_{name}")(**make_kw)
    army = dict(n_ops=n_ops, t_min_ns=5_000_000, t_max_ns=300_000_000)
    if name == "kvchaos":
        army["n_replicas"] = make_kw.get("n_replicas", 4)
    jplan, tplan = plan_pair(jmod, tmod, army)
    return run_plan_both(jwl, twl, jplan, tplan, dict(pool_size=pool, **CFG_KW), seeds,
                         n_steps, lat=dict(ops=n_ops, phases=2))
