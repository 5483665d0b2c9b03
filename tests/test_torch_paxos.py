"""paxos (single-decree synod with dueling proposers and proposer-crash
chaos, default variant) in the torch port against the JAX package and
the C++ oracle (oracle id 7), and its device handlers
(csrc/model_paxos.cuh) built for the host against the plain step.
Eight nodes, five declared draw purposes, replies to the event's sender
and the NACK fast-forward. ``durable_acceptors`` runs on the CPU only.
Exact equality."""

import numpy as np
import pytest

from madsim_tpu.models import make_paxos as j_make
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.models import SOAK_SPECS
from madsim_tpu_torch.models import make_paxos as t_make
from madsim_tpu_torch.models.paxos import A_VAL, P_DEC

from _torch_host import assert_host_matches_plain, build_host_kernel
from _torch_parity import (
    assert_oracle_traces, assert_soak_spec, assert_workload_equal, needs_oracle,
    run_both,
)

NAME = "paxos"
_F, KW, _N, CAP = SOAK_SPECS[NAME]
SEEDS = np.arange(96, dtype=np.uint64) * np.uint64(7919)
MID = 35  # fixed steps: a third of the way to the last halt


def _agreement(t, a=5, p=3):
    """Agreement and validity of the proposers' decisions, and a
    majority of acceptors holding the decided value."""
    ns = t["node_state"]
    dec = ns[:, a:, P_DEC]
    value = dec.max(1)
    assert ((dec == 0) | (dec == value[:, None])).all()
    assert ((value >= 1) & (value <= p)).all()
    assert ((ns[:, :a, A_VAL] == value[:, None]).sum(1) >= a // 2 + 1).all()


def test_soak_spec_and_workload_equal_reference():
    assert_soak_spec(NAME, t_make, {}, dict(pool_size=64, loss_p=0.02), 8192, 400)
    assert_workload_equal(j_make(), t_make())
    assert fused.workload_shape(t_make()) == fused.MODELS[NAME].shape


def test_soak_run_while_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, CAP, until_halted=True)
    assert t["halted"].all() and t["overflow"].sum() == 0
    _agreement(t)
    # some seeds' proposer crash came before the decision
    assert (t["epoch"].sum(1) > 0).any()


def test_fixed_steps_mid_run_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, MID, until_halted=False)
    assert t["ev_valid"].any(axis=1).all() and not t["halted"].all()


WORDS = dict(start_min_ns=1_000_000, start_max_ns=10_000_000,
             timeout_min_ns=30_000_000, timeout_max_ns=50_000_000,
             kill_min_ns=5_000_000, kill_max_ns=40_000_000,
             revive_min_ns=20_000_000, revive_max_ns=90_000_000)


def test_runtime_words_follow_the_factory(host_lib):
    t = run_both(j_make(**WORDS), t_make(**WORDS), KW, SEEDS[:32], CAP,
                 until_halted=True)
    assert t["halted"].all()
    _agreement(t)
    assert_host_matches_plain(host_lib, t_make(**WORDS), tcore.EngineConfig(**KW),
                              SEEDS[:32], CAP, True)


def test_durable_acceptors_match_reference_on_the_cpu():
    t = run_both(j_make(durable_acceptors=True), t_make(durable_acceptors=True), KW,
                 SEEDS[:32], CAP, until_halted=True)
    assert t["halted"].all()
    _agreement(t)


@needs_oracle
def test_traces_match_cpp_oracle():
    t = assert_oracle_traces(j_make(), t_make(), KW, 120)
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


def test_record_run_matches_reference_per_field():
    """paxos-record: every decision reached or first adopted is an
    OP_DECIDE record, all 32 history rows equal."""
    t = run_both(j_make(record=True), t_make(record=True), KW, SEEDS[:32], CAP,
                 until_halted=True)
    assert t["halted"].all() and (t["hist_count"] >= 1).all()


@pytest.mark.parametrize(
    "kw,key", [(dict(durable_acceptors=True), "paxos-durable"),
               (dict(chaos=False), "paxos-nochaos"), (dict(n_proposers=2), "paxos-p2")],
    ids=["durable_acceptors", "no_chaos", "two_proposers"],
)
def test_kernel_refuses_other_variants(kw, key):
    """Carried since the libraries are derived from the workload: the
    variant's own library, its key stable and its compile-time shape the
    workload's, where no registered library fits."""
    wl = t_make(**kw)
    spec = fused.kernel_model(wl)
    assert spec.key == key and spec.key not in fused.MODELS
    assert spec.shape == fused.workload_shape(wl) and spec == fused.derive_model(wl)
