"""broadcast (5-node reliable broadcast under a random link partition)
in the torch port against the JAX package and the C++ oracle (oracle id
3), and its device handlers (csrc/model_broadcast.cuh) built for the
host against the plain step. The init emits the engine's CLOG/UNCLOG
rows, so these runs set and clear the clog matrix (the partitioned link
joins two receivers, which never message each other, so no delivery
waits on it). Exact equality."""

import numpy as np
import pytest

from madsim_tpu.models import make_broadcast as j_make
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.models import BENCH_SPECS
from madsim_tpu_torch.models import make_broadcast as t_make

from _torch_host import assert_host_matches_plain, build_host_kernel
from _torch_parity import (
    assert_bench_spec_equal, assert_oracle_traces, assert_workload_equal,
    needs_oracle, run_both,
)

NAME = "broadcast"
_F, KW, _N, CAP = BENCH_SPECS[NAME]
SEEDS = np.arange(128, dtype=np.uint64) * np.uint64(7919)
MID = 20  # fixed steps: a third of the way to the last halt


def test_bench_spec_and_workload_equal_reference():
    assert_bench_spec_equal(NAME)
    assert_workload_equal(j_make(), t_make())
    assert fused.workload_shape(t_make()) == fused.MODELS[NAME].shape


def test_bench_run_while_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, CAP, until_halted=True)
    assert t["halted"].all() and t["overflow"].sum() == 0
    # every round fully acked at the origin
    assert (t["node_state"][:, 0, 0] == 5).all() and (t["node_state"][:, 0, 1] == 15).all()


def test_fixed_steps_mid_run_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, MID, until_halted=False)
    assert t["ev_valid"].any(axis=1).all() and t["clog"].any()


def test_runtime_words_follow_the_factory():
    run_both(j_make(rounds=2, retx_ns=20_000_000), t_make(rounds=2, retx_ns=20_000_000),
             KW, SEEDS[:32], CAP, until_halted=True)


@needs_oracle
def test_traces_match_cpp_oracle():
    t = assert_oracle_traces(j_make(), t_make(), KW, 200)
    assert t["halted"].all()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp(NAME), fused.MODELS[NAME],
                             (KW["pool_size"],))


@pytest.mark.parametrize("n_steps,until_halted", [(CAP, True), (MID, False)],
                         ids=["run_while", "fixed"])
def test_host_built_kernel_matches_plain_step(host_lib, n_steps, until_halted):
    want = assert_host_matches_plain(host_lib, t_make(), tcore.EngineConfig(**KW),
                              SEEDS[:64], n_steps, until_halted)
    assert until_halted or want["clog"].any()


@pytest.mark.parametrize("kw,key", [(dict(partition=False), "broadcast-nopartition"),
                                    (dict(n_nodes=4), "broadcast-n4")],
                         ids=["no_partition", "four_nodes"])
def test_kernel_refuses_other_variants(kw, key):
    """Carried since the libraries are derived from the workload: the
    variant's own library, its key stable and its compile-time shape the
    workload's, where no registered library fits."""
    wl = t_make(**kw)
    spec = fused.kernel_model(wl)
    assert spec.key == key and spec.key not in fused.MODELS
    assert spec.shape == fused.workload_shape(wl) and spec == fused.derive_model(wl)
