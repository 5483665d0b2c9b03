"""snapshot (Lai-Yang distributed snapshot over money transfers) in the
torch port against the JAX package and the C++ oracle (oracle id 8), and
its device handlers (csrc/model_snapshot.cuh) built for the host against
the plain step. Loss-free, pool 96; the paint broadcast keeps a self row
that is never valid. Exact equality."""

import numpy as np
import pytest

from madsim_tpu.models import make_snapshot as j_make
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.models import SOAK_SPECS
from madsim_tpu_torch.models import make_snapshot as t_make
from madsim_tpu_torch.models.snapshot import CHANIN, COLOR, RECBAL

from _torch_host import assert_host_matches_plain, build_host_kernel
from _torch_parity import (
    assert_oracle_traces, assert_soak_spec, assert_workload_equal, needs_oracle,
    run_both,
)

NAME = "snapshot"
_F, KW, _N, CAP = SOAK_SPECS[NAME]
SEEDS = np.arange(96, dtype=np.uint64) * np.uint64(7919)
MID = 45  # fixed steps: a third of the way to the last halt


def _conserved(t, n_nodes=5, balance=1000):
    """Conservation over the cut, and every node recorded (turned red)."""
    ns = t["node_state"]
    assert (ns[:, :, COLOR] == 1).all()
    total = ns[:, :, RECBAL].sum(1) + ns[:, :, CHANIN].sum(1)
    assert (total == n_nodes * balance).all()


def test_soak_spec_and_workload_equal_reference():
    assert_soak_spec(NAME, t_make, {}, dict(pool_size=96), 8192, 400)
    assert_workload_equal(j_make(), t_make())
    assert fused.workload_shape(t_make()) == fused.MODELS[NAME].shape


def test_soak_run_while_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, CAP, until_halted=True)
    assert t["halted"].all() and t["overflow"].sum() == 0
    # the witness counted every transfer and paint: 5 * 6 + 5 * 4
    assert (t["node_state"][:, 0, 5] == 50).all()
    _conserved(t)


def test_fixed_steps_mid_run_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, MID, until_halted=False)
    assert t["ev_valid"].any(axis=1).all() and not t["halted"].all()


WORDS = dict(n_sends=3, balance=500, amount_max=40, send_min_ns=2_000_000,
             send_max_ns=12_000_000, snap_min_ns=5_000_000, snap_max_ns=30_000_000)


def test_runtime_words_follow_the_factory(host_lib):
    t = run_both(j_make(**WORDS), t_make(**WORDS), KW, SEEDS[:32], CAP, until_halted=True)
    assert t["halted"].all()
    _conserved(t, balance=500)
    assert_host_matches_plain(host_lib, t_make(**WORDS), tcore.EngineConfig(**KW),
                              SEEDS[:32], CAP, True)


@needs_oracle
def test_traces_match_cpp_oracle():
    t = assert_oracle_traces(j_make(), t_make(), KW, 200)
    assert t["halted"].any()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp(NAME), fused.MODELS[NAME],
                             (KW["pool_size"],))


@pytest.mark.parametrize("n_steps,until_halted", [(CAP, True), (MID, False)],
                         ids=["run_while", "fixed"])
def test_host_built_kernel_matches_plain_step(host_lib, n_steps, until_halted):
    assert_host_matches_plain(host_lib, t_make(), tcore.EngineConfig(**KW),
                              SEEDS[:48], n_steps, until_halted)


def test_kernel_refuses_other_variants():
    """Carried since the libraries are derived from the workload: four
    nodes derive their own library, its compile-time shape the
    workload's."""
    wl = t_make(n_nodes=4)
    spec = fused.kernel_model(wl)
    assert spec.key == "snapshot-n4" and spec.cxx == "madsim::SnapshotModelT<4>"
    assert spec.shape == fused.workload_shape(wl)
