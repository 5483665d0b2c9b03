"""Shared helper of the torch port's parity tests: per-field equality
of a port SimState with a JAX package SimState, and the checks each
ported model of BENCH_SPECS or SOAK_SPECS runs against the reference
(its spec and workload shape, a run through both engines, the C++
oracle's traces)."""

import _torch_threads  # noqa: F401
import dataclasses
import shutil

import numpy as np
import pytest

import jax

import madsim_tpu.engine as je
from madsim_tpu.models import BENCH_SPECS as J_SPECS
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.models import BENCH_SPECS as T_SPECS
from madsim_tpu_torch.models import SOAK_SPECS as T_SOAK


def jax_fields(st) -> dict:
    return {
        f.name: np.asarray(getattr(st, f.name))
        for f in dataclasses.fields(je.SimState)
    }


def assert_same_state(jst, tst):
    """Every port field equals the reference's (values and dtypes); the
    reference's other fields are empty or zero for these workloads."""
    j, t = jax_fields(jst), state_to_numpy(tst)
    for name, v in t.items():
        assert j[name].dtype == v.dtype, name
        np.testing.assert_array_equal(v, j[name], err_msg=f"field {name}")
    for name in set(j) - set(t):
        assert j[name].size == 0 or not j[name].any(), name


# ---------------------------------------------------------------------------
# a model of BENCH_SPECS or SOAK_SPECS in both frameworks
# ---------------------------------------------------------------------------

ORACLE_SEEDS = [0, 1, 2, 3, 1234, 99991, 2**32 + 5, 2**63 + 11]

needs_oracle = pytest.mark.skipif(
    shutil.which("make") is None or shutil.which("g++") is None,
    reason="native toolchain unavailable",
)

WORKLOAD_ATTRS = ("name", "n_nodes", "state_width", "max_emits", "args_words",
                  "payload_words", "draw_purposes", "durable_cols")


def assert_bench_spec_equal(name):
    """BENCH_SPECS[name] is the reference's: factory, engine kwargs,
    seed count and step cap."""
    jf, jkw, jn, jcap = J_SPECS[name]
    tf, tkw, tn, tcap = T_SPECS[name]
    assert (tkw, tn, tcap) == (jkw, jn, jcap)
    assert tf.__name__ == jf.__name__


def assert_soak_spec(name, factory, factory_kw, kw, n_seeds, cap):
    """SOAK_SPECS[name] is the literal configuration of the JAX
    package's soak: the factory (with its keyword arguments), engine
    kwargs, seed count and step cap."""
    tf, tkw, tn, tcap = T_SOAK[name]
    assert (tkw, tn, tcap) == (kw, n_seeds, cap)
    assert getattr(tf, "func", tf) is factory
    assert getattr(tf, "keywords", {}) == factory_kw


def assert_workload_equal(jw, tw):
    """The port's workload has the reference's shape, handler count,
    draw purposes and restart tables."""
    for attr in WORKLOAD_ATTRS:
        assert getattr(tw, attr) == getattr(jw, attr), attr
    assert len(tw.handlers) == len(jw.handlers)
    np.testing.assert_array_equal(tw.initial_state(), jw.initial_state())
    np.testing.assert_array_equal(tw.volatile_mask(), jw.volatile_mask())


def run_both(jwl, twl, kw, seeds, n_steps, until_halted):
    """The same seeds through the JAX engine (CPU, scatter layout, int64
    times) and the port's plain step; asserts every field equal and
    returns the port's state as numpy."""
    jcfg, tcfg = je.EngineConfig(**kw), tcore.EngineConfig(**kw)
    js = je.make_init(jwl, jcfg, time32=False)(seeds)
    ts = tcore.make_init(twl, tcfg, device="cpu")(seeds)
    assert_same_state(js, ts)
    jmake = je.make_run_while if until_halted else je.make_run
    tmake = tcore.make_run_while if until_halted else tcore.make_run
    jo = jax.jit(jmake(jwl, jcfg, n_steps, layout="scatter", time32=False))(js)
    to = tmake(twl, tcfg, n_steps)(ts)
    assert_same_state(jo, to)
    return state_to_numpy(to)


def assert_oracle_traces(jwl, twl, kw, n_steps, seeds=ORACLE_SEEDS, **model_kwargs):
    """trace, clock, halt time, messages and node rows of the port's
    fixed-step run equal the C++ oracle's, seed by seed; ``model_kwargs``
    are the factory's arguments, as ``run_oracle`` takes them."""
    from madsim_tpu.engine.oracle import run_oracle

    tcfg = tcore.EngineConfig(**kw)
    to = state_to_numpy(tcore.make_run(twl, tcfg, n_steps)(
        tcore.make_init(twl, tcfg, device="cpu")(np.array(seeds, np.uint64))
    ))
    for i, seed in enumerate(seeds):
        o = run_oracle(jwl, je.EngineConfig(**kw), seed, n_steps, **model_kwargs)
        assert int(to["trace"][i]) == o.trace, seed
        assert int(to["now"][i]) == o.now, seed
        assert int(to["halt_time"][i]) == o.halt_time, seed
        assert bool(to["halted"][i]) == o.halted, seed
        assert int(to["msg_count"][i]) == o.msg_count, seed
        assert int(to["overflow"][i]) == o.overflow, seed
        np.testing.assert_array_equal(to["node_state"][i], o.node_state)
    return to
