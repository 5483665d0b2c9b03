"""The port's main path — raft election — against the JAX package.

Per-field SimState equality with the JAX engine (CPU, ``layout=
"scatter", time32=False``) at the ``entry()`` shape and the
``BENCH_SPECS["raft"]`` shape, trace/clock/halt time equality with the
C++ oracle, the time limit and certain-loss paths, and what a halted
seed's step does. Exact equality: the engine is integer arithmetic.
"""

import dataclasses
import shutil

import numpy as np
import pytest

import jax

import madsim_tpu.engine as je
from madsim_tpu.engine import core as jcore
from madsim_tpu.models import BENCH_SPECS as J_SPECS
from madsim_tpu.models import make_raft as j_raft
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.models import BENCH_SPECS as T_SPECS
from madsim_tpu_torch.models import make_raft as t_raft

from _torch_parity import assert_same_state, run_both

BENCH_KW = J_SPECS["raft"][1]
ENTRY_KW = dict(pool_size=128, loss_p=0.02)

needs_oracle = pytest.mark.skipif(
    shutil.which("make") is None or shutil.which("g++") is None,
    reason="native toolchain unavailable",
)


def _pair(kw, n_seeds):
    jcfg, tcfg = je.EngineConfig(**kw), tcore.EngineConfig(**kw)
    seeds = np.arange(n_seeds, dtype=np.uint64)
    js = je.make_init(j_raft(), jcfg, time32=False)(seeds)
    ts = tcore.make_init(t_raft(), tcfg, device="cpu")(seeds)
    return jcfg, tcfg, js, ts


def _j_run(jcfg, n_steps, js, until_halted=False):
    make = je.make_run_while if until_halted else je.make_run
    return jax.jit(make(j_raft(), jcfg, n_steps, layout="scatter", time32=False))(js)


def test_bench_spec_and_workload_equal_reference():
    jf, jkw, jn, jcap = J_SPECS["raft"]
    tf, tkw, tn, tcap = T_SPECS["raft"]
    assert (tkw, tn, tcap) == (jkw, jn, jcap)
    jw, tw = jf(), tf()
    for attr in ("name", "n_nodes", "state_width", "max_emits", "args_words",
                 "payload_words", "draw_purposes", "durable_cols"):
        assert getattr(tw, attr) == getattr(jw, attr), attr
    np.testing.assert_array_equal(tw.initial_state(), jw.initial_state())
    np.testing.assert_array_equal(tw.volatile_mask(), jw.volatile_mask())


def test_record_run_matches_reference_per_field():
    """raft-election-record: every election win is an OP_ELECT record
    (key = term, arg = the winner), all eight history rows equal."""
    _f, _kw, _n, cap = T_SPECS["raft"]
    t = run_both(j_raft(record=True), t_raft(record=True), BENCH_KW,
                 np.arange(64, dtype=np.uint64), cap, until_halted=True)
    assert t["halted"].all() and (t["hist_count"] >= 1).all()
    assert t["hist_word"].shape == (64, 8, 5) and (t["hist_drop"] == 0).all()


@pytest.mark.parametrize("n_steps", [1, 30])
def test_entry_shape_matches_reference_per_field(n_steps):
    jcfg, tcfg, js, ts = _pair(ENTRY_KW, 1024)
    assert_same_state(js, ts)
    assert_same_state(_j_run(jcfg, n_steps, js), tcore.make_run(t_raft(), tcfg, n_steps)(ts))


def test_bench_shape_run_while_matches_reference_per_field():
    _f, _kw, _n, cap = T_SPECS["raft"]
    jcfg, tcfg, js, ts = _pair(BENCH_KW, 256)
    jo = _j_run(jcfg, cap, js, until_halted=True)
    to = tcore.make_run_while(t_raft(), tcfg, cap)(ts)
    assert_same_state(jo, to)
    t = state_to_numpy(to)
    assert t["halted"].all() and t["overflow"].sum() == 0
    assert (t["step"] == t["step"][0]).all() and 0 < t["step"][0] < cap


@pytest.mark.parametrize(
    "kw,n_steps",
    [
        (dict(pool_size=40, loss_p=0.02, time_limit_ns=200_000_000), 120),
        (dict(pool_size=40, loss_p=1.0), 40),
    ],
    ids=["time_limit", "certain_loss"],
)
def test_limit_and_loss_paths_match_reference(kw, n_steps):
    jcfg, tcfg, js, ts = _pair(kw, 64)
    to = tcore.make_run(t_raft(), tcfg, n_steps)(ts)
    assert_same_state(_j_run(jcfg, n_steps, js), to)
    t = state_to_numpy(to)
    if kw.get("time_limit_ns"):
        # every seed halted by the limit; some of them with no leader
        leader = (t["node_state"][:, :, 0] == 2).any(axis=1)
        assert t["halted"].all() and (t["halt_time"] <= kw["time_limit_ns"]).all()
        assert leader.any() and not leader.all()
    else:
        assert not t["halted"].any() and t["msg_count"].sum() > 0


def test_halted_step_changes_only_step_and_drains_one_slot():
    """A halted seed's step dispatches nothing, but (as in the
    reference) it still consumes its earliest valid slot and counts."""
    jcfg, tcfg, js, ts = _pair(BENCH_KW, 32)
    ts = tcore.make_run_while(t_raft(), tcfg, 600)(ts)
    js = _j_run(jcfg, 600, js, until_halted=True)
    before = state_to_numpy(ts)
    assert before["halted"].all() and before["ev_valid"].any(axis=1).all()
    to = tcore.make_step(t_raft(), tcfg)(ts)
    jo = jax.jit(jax.vmap(jcore.make_step(j_raft(), jcfg, layout="scatter", time32=False)))(js)
    assert_same_state(jo, to)
    after = state_to_numpy(to)
    changed = {k for k in before if not np.array_equal(before[k], after[k])}
    assert changed == {"step", "ev_valid"}
    np.testing.assert_array_equal(after["step"], before["step"] + 1)
    t = np.where(before["ev_valid"], before["ev_time"], 2**62)
    drained = before["ev_valid"] & ~after["ev_valid"]
    assert (drained.sum(axis=1) == 1).all()
    # numpy's argmin keeps the first minimum, like the engine's pop
    np.testing.assert_array_equal(np.argmax(drained, axis=1), np.argmin(t, axis=1))


@needs_oracle
@pytest.mark.parametrize(
    "kw,n_steps",
    [(BENCH_KW, 200), (dict(pool_size=40, loss_p=0.02, time_limit_ns=200_000_000), 120)],
    ids=["bench", "time_limit"],
)
def test_traces_match_cpp_oracle(kw, n_steps):
    from madsim_tpu.engine.oracle import run_oracle

    tcfg = tcore.EngineConfig(**kw)
    seeds = [0, 1, 2, 3, 1234, 99991, 2**32 + 5, 2**63 + 11]
    to = state_to_numpy(tcore.make_run(t_raft(), tcfg, n_steps)(
        tcore.make_init(t_raft(), tcfg, device="cpu")(np.array(seeds, np.uint64))
    ))
    for i, seed in enumerate(seeds):
        o = run_oracle(j_raft(), je.EngineConfig(**kw), seed, n_steps)
        assert int(to["trace"][i]) == o.trace, seed
        assert int(to["now"][i]) == o.now, seed
        assert int(to["halt_time"][i]) == o.halt_time, seed
        assert bool(to["halted"][i]) == o.halted, seed
        assert int(to["msg_count"][i]) == o.msg_count, seed
        np.testing.assert_array_equal(to["node_state"][i], o.node_state)


def test_reference_checkers_take_the_ports_output():
    """state_to_numpy hands the port's output to the JAX package's own
    compare_traces unchanged."""
    jcfg, tcfg, js, ts = _pair(ENTRY_KW, 64)
    to = tcore.make_run(t_raft(), tcfg, 20)(ts)
    jo = _j_run(jcfg, 20, js)
    port = type("Port", (), state_to_numpy(to))
    je.compare_traces(port, jo, what="port-vs-jax", history=False)
    fields = {f.name for f in dataclasses.fields(je.SimState)}
    assert set(state_to_numpy(to)) <= fields


def test_port_compare_traces_names_the_first_diverging_seed():
    from madsim_tpu_torch.engine import DeterminismError, compare_traces

    _jcfg, tcfg, _js, ts = _pair(ENTRY_KW, 8)
    a = tcore.make_run(t_raft(), tcfg, 12)(ts)
    b = tcore.make_run(t_raft(), tcfg, 12)(ts)
    compare_traces(a, b)
    b.trace[5] ^= 1
    with pytest.raises(DeterminismError, match="seed index 5"):
        compare_traces(a, b)
