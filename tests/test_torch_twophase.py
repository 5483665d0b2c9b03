"""twophase (two-phase commit under participant-crash chaos, default
variant) in the torch port against the JAX package and the C++ oracle
(oracle id 5), and its device handlers (csrc/model_twophase.cuh) built
for the host against the plain step. Three args words and up to ten
emits: the retransmit handler's PREPARE and DECISION rows share the
per-participant row range by phase. Exact equality."""

import numpy as np
import pytest

from madsim_tpu.models import make_twophase as j_make
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.models import SOAK_SPECS
from madsim_tpu_torch.models import make_twophase as t_make

from _torch_host import assert_host_matches_plain, build_host_kernel
from _torch_parity import (
    assert_oracle_traces, assert_soak_spec, assert_workload_equal, needs_oracle,
    run_both,
)

NAME = "twophase"
_F, KW, _N, CAP = SOAK_SPECS[NAME]
TXNS = 4  # the soak's factory argument
SEEDS = np.arange(96, dtype=np.uint64) * np.uint64(7919)
MID = 40  # fixed steps: a third of the way to the last halt


def _atomic(t, txns=TXNS):
    """At halt every transaction was decided, and every participant
    applied the final one and holds the coordinator's decision."""
    ns = t["node_state"]
    assert (ns[:, 0, 0] == txns).all()
    assert (ns[:, 0, 4] + ns[:, 0, 5] == txns).all()
    assert (ns[:, 1:, 2] == txns).all()
    assert (ns[:, 1:, 4] == (ns[:, 0, 1:2] == 1)).all()


def test_soak_spec_and_workload_equal_reference():
    assert_soak_spec(NAME, t_make, dict(txns=4), dict(pool_size=64, loss_p=0.03),
                     8192, 500)
    assert_workload_equal(j_make(txns=TXNS), t_make(txns=TXNS))
    assert fused.workload_shape(t_make(txns=TXNS)) == fused.MODELS[NAME].shape


def test_soak_run_while_matches_reference_per_field():
    t = run_both(j_make(txns=TXNS), t_make(txns=TXNS), KW, SEEDS, CAP, until_halted=True)
    assert t["halted"].all() and t["overflow"].sum() == 0
    _atomic(t)
    # seeds that ran past their scheduled kill went through the restart,
    # and some participants aborted
    assert (t["epoch"].sum(1) == 2).any() and (t["node_state"][:, 0, 5] > 0).any()


def test_fixed_steps_mid_run_matches_reference_per_field():
    t = run_both(j_make(txns=TXNS), t_make(txns=TXNS), KW, SEEDS, MID,
                 until_halted=False)
    assert t["ev_valid"].any(axis=1).all() and not t["halted"].all()


WORDS = dict(txns=3, no_pct=40, retx_ns=25_000_000, revive_min_ns=60_000_000,
             revive_max_ns=200_000_000)


def test_runtime_words_follow_the_factory(host_lib):
    t = run_both(j_make(**WORDS), t_make(**WORDS), KW, SEEDS[:32], CAP,
                 until_halted=True)
    assert t["halted"].all()
    _atomic(t, txns=3)
    assert_host_matches_plain(host_lib, t_make(**WORDS), tcore.EngineConfig(**KW),
                              SEEDS[:32], CAP, True)


@needs_oracle
def test_traces_match_cpp_oracle():
    t = assert_oracle_traces(j_make(txns=TXNS), t_make(txns=TXNS), KW, 150, txns=TXNS)
    assert t["halted"].any()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp(NAME), fused.MODELS[NAME],
                             (KW["pool_size"],))


@pytest.mark.parametrize("n_steps,until_halted", [(CAP, True), (MID, False)],
                         ids=["run_while", "fixed"])
def test_host_built_kernel_matches_plain_step(host_lib, n_steps, until_halted):
    want = assert_host_matches_plain(host_lib, t_make(txns=TXNS), tcore.EngineConfig(**KW),
                                     SEEDS[:48], n_steps, until_halted)
    assert want["epoch"].max() >= 1


def test_record_run_matches_reference_per_field():
    """twophase-record: every decision taken or adopted is an OP_DECIDE
    record (key = txn), all history rows equal."""
    t = run_both(j_make(txns=TXNS, record=True), t_make(txns=TXNS, record=True), KW,
                 SEEDS[:32], CAP, until_halted=True)
    _atomic(t)
    # the coordinator and the four participants decide every txn
    assert (t["hist_count"] >= TXNS * 5).all()


@pytest.mark.parametrize("kw,key", [(dict(chaos=False), "twophase-nochaos"),
                                    (dict(n_parts=3), "twophase-p3")],
                         ids=["no_chaos", "three_parts"])
def test_kernel_refuses_other_variants(kw, key):
    """Carried since the libraries are derived from the workload: the
    variant's own library, its key stable and its compile-time shape the
    workload's, where no registered library fits."""
    wl = t_make(**kw)
    spec = fused.kernel_model(wl)
    assert spec.key == key and spec.key not in fused.MODELS
    assert spec.shape == fused.workload_shape(wl) and spec == fused.derive_model(wl)
