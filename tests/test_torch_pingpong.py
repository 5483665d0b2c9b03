"""pingpong (3-node RPC) in the torch port against the JAX package and
the C++ oracle (oracle id 0), and its device handlers
(csrc/model_pingpong.cuh) built for the host against the plain step.
The bench runs one seed; these tests add a few more. Exact equality."""

import numpy as np
import pytest

from madsim_tpu.models import make_pingpong as j_make
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.models import BENCH_SPECS
from madsim_tpu_torch.models import make_pingpong as t_make

from _torch_host import assert_host_matches_plain, build_host_kernel
from _torch_parity import (
    assert_bench_spec_equal, assert_oracle_traces, assert_workload_equal,
    needs_oracle, run_both,
)

NAME = "pingpong"
_F, KW, N_SEEDS, CAP = BENCH_SPECS[NAME]
MID = 15  # fixed steps: a third of the way to the halt at step 46


def test_bench_spec_and_workload_equal_reference():
    assert_bench_spec_equal(NAME)
    assert N_SEEDS == 1
    assert_workload_equal(j_make(), t_make())
    assert fused.workload_shape(t_make()) == fused.MODELS[NAME].shape


@pytest.mark.parametrize("n_seeds", [1, 64], ids=["bench_1", "seeds_64"])
def test_bench_run_while_matches_reference_per_field(n_seeds):
    seeds = np.arange(n_seeds, dtype=np.uint64) * np.uint64(104729)
    t = run_both(j_make(), t_make(), KW, seeds, CAP, until_halted=True)
    assert t["halted"].all() and t["overflow"].sum() == 0
    # both clients finished their 10 rounds; the server served 20 pings
    assert (t["node_state"][:, 1:, 0] == 10).all() and (t["node_state"][:, 0, 1] == 20).all()


def test_fixed_steps_mid_run_matches_reference_per_field():
    seeds = np.arange(16, dtype=np.uint64)
    t = run_both(j_make(), t_make(), KW, seeds, MID, until_halted=False)
    assert t["ev_valid"].any(axis=1).all() and not t["halted"].any()


def test_runtime_words_follow_the_factory():
    run_both(j_make(rounds=3), t_make(rounds=3), KW, np.arange(8, dtype=np.uint64),
             CAP, until_halted=True)


@needs_oracle
def test_traces_match_cpp_oracle():
    t = assert_oracle_traces(j_make(), t_make(), KW, CAP, rounds=10)
    assert t["halted"].all()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp(NAME), fused.MODELS[NAME],
                             (KW["pool_size"],))


@pytest.mark.parametrize("n_steps,until_halted", [(CAP, True), (MID, False)],
                         ids=["run_while", "fixed"])
def test_host_built_kernel_matches_plain_step(host_lib, n_steps, until_halted):
    assert_host_matches_plain(host_lib, t_make(), tcore.EngineConfig(**KW),
                              np.arange(32, dtype=np.uint64), n_steps, until_halted)


def test_kernel_refuses_another_client_count():
    """Carried since the libraries are derived from the workload: three
    clients derive their own library, its compile-time shape the
    workload's."""
    wl = t_make(n_clients=3)
    spec = fused.kernel_model(wl)
    assert spec.key == "pingpong-c3" and spec.cxx == "madsim::PingpongModelT<3>"
    assert spec.shape == fused.workload_shape(wl)
