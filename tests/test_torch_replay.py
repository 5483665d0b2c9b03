"""The port's oracle replay: a failing seed's readable timeline.

``refold(replay(...))`` equals the trace of the port's batched run and
the oracle's, for raft and kvchaos with the payload arena, as
``tests/test_replay.py`` holds the JAX package's; the port's copy of
the oracle bridge, built into its own directory, gives the JAX
package's bridge's results. Exact equality.
"""

import _torch_threads  # noqa: F401
import shutil

import numpy as np
import pytest

import madsim_tpu.engine as je
from madsim_tpu.engine.oracle import run_oracle as j_run_oracle
from madsim_tpu.models import make_kvchaos as j_kvchaos
from madsim_tpu.models import make_raft as j_raft
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import oracle
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.engine.replay import format_timeline, refold, replay
from madsim_tpu_torch.models import BENCH_SPECS, make_kvchaos, make_raft

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="native toolchain unavailable"
)

SEEDS = [0, 1, 2, 3, 2**63 + 11]
# name -> (JAX factory, port factory, engine kwargs, steps)
CASES = {
    "raft": (j_raft, make_raft, BENCH_SPECS["raft"][1], 120),
    "kvchaos-payload": (lambda: j_kvchaos(payload=True), lambda: make_kvchaos(payload=True),
                        BENCH_SPECS["kvchaos"][1], 400),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_replay_refolds_to_port_and_oracle_trace(name):
    jf, tf, kw, n_steps = CASES[name]
    wl, cfg = tf(), tcore.EngineConfig(**kw)
    seeds = np.array(SEEDS, np.uint64)
    out = state_to_numpy(tcore.make_run(wl, cfg, n_steps)(tcore.make_init(wl, cfg, device="cpu")(seeds)))
    for i, seed in enumerate(SEEDS):
        events, res = replay(wl, cfg, seed, n_steps)
        assert events, "a run must dispatch events"
        assert res.trace == int(out["trace"][i]), f"oracle vs port trace, seed {seed}"
        assert refold(events, wl) == int(out["trace"][i]), f"refold, seed {seed}"
        times = [e.time_ns for e in events]
        assert times == sorted(times), "timeline is time-ordered"
        ref = j_run_oracle(jf(), je.EngineConfig(**kw), seed, n_steps)
        assert (res.trace, res.now, res.msg_count, res.halted, res.halt_time, res.overflow) == (
            ref.trace, ref.now, ref.msg_count, ref.halted, ref.halt_time, ref.overflow)
        np.testing.assert_array_equal(res.node_state, ref.node_state)


def test_replay_grows_past_cap():
    wl, cfg = make_raft(), tcore.EngineConfig(**BENCH_SPECS["raft"][1])
    small, res_small = replay(wl, cfg, 7, 200, cap=8)
    big, res_big = replay(wl, cfg, 7, 200, cap=65536)
    assert len(small) > 8 and res_small.trace == res_big.trace
    assert small == big


def test_timeline_names_engine_kinds():
    wl, cfg = make_kvchaos(writes=5), tcore.EngineConfig(**BENCH_SPECS["kvchaos"][1])
    for seed in range(16):
        events, res = replay(wl, cfg, seed, 900)
        text = format_timeline(events, res, wl)
        if "KILL(" in text:
            break
    else:
        raise AssertionError("no seed in 0..15 dispatched its chaos kill")
    assert "init(" in text and "user[" not in text and "halted=" in text
    assert text.count("\n") == len(events)


def test_model_kwargs_override_model_params():
    """The oracle runs the workload's own parameters unless told
    otherwise, so a replay of a non-default factory needs no repeats."""
    cfg = tcore.EngineConfig(**BENCH_SPECS["kvchaos"][1])
    own = oracle.run_oracle(make_kvchaos(writes=5), cfg, 3, 900)
    told = oracle.run_oracle(make_kvchaos(), cfg, 3, 900, writes=5)
    default = oracle.run_oracle(make_kvchaos(), cfg, 3, 900)
    assert own.trace == told.trace != default.trace
    assert oracle.build().parent.parent == oracle.BUILD_ROOT
