"""microbench (single-node timer + RNG loop) in the torch port against
the JAX package and the C++ oracle (oracle id 1), and its device
handlers (csrc/model_microbench.cuh) built for the host against the
plain step. Exact equality: the engine is integer arithmetic."""

import dataclasses

import numpy as np
import pytest

from madsim_tpu.models import make_microbench as j_make
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.models import BENCH_SPECS
from madsim_tpu_torch.models import make_microbench as t_make

from _torch_host import assert_host_matches_plain, build_host_kernel
from _torch_parity import (
    assert_bench_spec_equal, assert_oracle_traces, assert_workload_equal,
    needs_oracle, run_both,
)

NAME = "microbench"
_F, KW, _N, CAP = BENCH_SPECS[NAME]
SEEDS = np.arange(96, dtype=np.uint64) * np.uint64(7919)
MID = 300  # fixed steps: a third of the way to the halt at step 1002


def test_bench_spec_and_workload_equal_reference():
    assert_bench_spec_equal(NAME)
    assert_workload_equal(j_make(), t_make())
    assert fused.workload_shape(t_make()) == fused.MODELS[NAME].shape


def test_bench_run_while_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, CAP, until_halted=True)
    assert t["halted"].all() and t["overflow"].sum() == 0
    assert (t["node_state"][:, 0, 0] == 1000).all() and t["step"][0] == 1002


def test_fixed_steps_mid_run_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, MID, until_halted=False)
    assert t["ev_valid"].any(axis=1).all() and not t["halted"].any()


def test_runtime_words_follow_the_factory():
    """rounds and the delay range are runtime words, not compiled in."""
    run_both(j_make(rounds=40, delay_min_ns=10, delay_max_ns=5_000),
             t_make(rounds=40, delay_min_ns=10, delay_max_ns=5_000),
             KW, SEEDS[:16], 60, until_halted=True)


@needs_oracle
def test_traces_match_cpp_oracle():
    t = assert_oracle_traces(j_make(), t_make(), KW, CAP, rounds=1000)
    assert t["halted"].all()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp(NAME), fused.MODELS[NAME],
                             (KW["pool_size"],))


@pytest.mark.parametrize("n_steps,until_halted", [(CAP, True), (MID, False)],
                         ids=["run_while", "fixed"])
def test_host_built_kernel_matches_plain_step(host_lib, n_steps, until_halted):
    assert_host_matches_plain(host_lib, t_make(), tcore.EngineConfig(**KW),
                              SEEDS[:48], n_steps, until_halted)


def test_kernel_refuses_another_shape():
    wl = dataclasses.replace(t_make(), max_emits=3)
    with pytest.raises(NotImplementedError, match="compiled for 'microbench'"):
        fused.kernel_model(wl)
