"""raftlog (raft log replication under leader-crash chaos, the default
variant) in the torch port against the JAX package and the C++ oracle
(oracle id 6), and its device handlers (csrc/model_raftlog.cuh) built
for the host against the plain step. Four args words, four payload
words (AppendEntries carry the sender's whole log, entries packed as
value | term << 8) and a pool of 64. Exact equality."""

import numpy as np
import pytest

from madsim_tpu.models import make_raftlog as j_make
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.models import BENCH_SPECS
from madsim_tpu_torch.models import make_raftlog as t_make
from madsim_tpu_torch.models.raftlog import COMMIT, LOG0, LOGLEN

from _torch_host import assert_host_matches_plain, build_host_kernel
from _torch_parity import (
    assert_bench_spec_equal, assert_oracle_traces, assert_workload_equal,
    needs_oracle, run_both,
)

NAME = "raftlog"
_F, KW, _N, CAP = BENCH_SPECS[NAME]
SEEDS = np.arange(96, dtype=np.uint64) * np.uint64(7919)
MID = 50  # fixed steps: a third of the way to the last halt


def test_bench_spec_and_workload_equal_reference():
    assert_bench_spec_equal(NAME)
    assert_workload_equal(j_make(), t_make())
    assert fused.workload_shape(t_make()) == fused.MODELS[NAME].shape


def test_bench_run_while_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, CAP, until_halted=True)
    assert t["halted"].all() and t["overflow"].sum() == 0
    # the raft safety invariant at halt: the committed log (4 entries)
    # sits, equal, on a majority of nodes
    ns = t["node_state"]
    leader_log = ns[np.arange(len(SEEDS)), (ns[:, :, COMMIT] == 4).argmax(1), LOG0:]
    same = (ns[:, :, LOG0:] == leader_log[:, None, :]).all(2) & (ns[:, :, LOGLEN] == 4)
    assert (same.sum(1) >= 3).all()
    # the seeds that ran past their scheduled kill went through it, and
    # some also through the restart's re-init
    assert (t["epoch"].sum(1) == 2).any() and (~t["alive"]).any()


def test_fixed_steps_mid_run_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, MID, until_halted=False)
    assert t["ev_valid"].any(axis=1).all() and t["ev_pay"].any()


def test_runtime_words_follow_the_factory():
    kw = dict(timeout_min_ns=100_000_000, timeout_max_ns=200_000_000,
              propose_ns=10_000_000, retx_ns=30_000_000)
    run_both(j_make(**kw), t_make(**kw), KW, SEEDS[:32], CAP, until_halted=True)


@needs_oracle
def test_traces_match_cpp_oracle():
    t = assert_oracle_traces(j_make(), t_make(), KW, 250)
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


@pytest.mark.parametrize(
    "kw",
    [dict(durable=True), dict(durable=True, bug="nosync"), dict(army=True),
     dict(cov_spread=True)],
    ids=["durable", "nosync", "army", "cov_spread"],
)
def test_unported_modes_raise(kw):
    """Each mode builds now: durable and nosync (the sync discipline is
    ported), cov_spread (the coverage taps are) and army (the latency
    markers are: under its client army with the latency tap it equals
    the reference per field, its client node appended)."""
    if "army" in kw:
        from _torch_army import army_only_both

        t = army_only_both("raftlog", kw, 12, 64, 300, SEEDS[:16])
        assert t["lat_count"].sum() > 0 and t["node_state"].shape[1] == 6
        return
    if "cov_spread" in kw:
        wl = t_make(**kw)
        assert wl.cov_features is not None and t_make().cov_features is None
        assert dict(wl.model_params)["cov_spread"] is True
        return
    wl = t_make(**kw)
    assert wl.durable_sync and wl.name == ("raftlog-nosync" if "bug" in kw else "raftlog")
    assert wl.durable_cols == j_make(**kw).durable_cols
    with pytest.raises(ValueError, match="needs durable=True"):
        t_make(bug=kw.get("bug", "nosync"))


def test_record_run_matches_reference_per_field():
    """raftlog-record: elections and per-index commits, all 48 history
    rows equal."""
    t = run_both(j_make(record=True), t_make(record=True), KW, SEEDS[:16], CAP,
                 until_halted=True)
    assert t["hist_word"].shape == (16, 48, 5) and (t["hist_count"] >= 1).all()


@pytest.mark.parametrize("kw,key", [(dict(chaos=False), "raftlog-nochaos"),
                                    (dict(n_writes=3), "raftlog-w3")],
                         ids=["no_chaos", "three_writes"])
def test_kernel_refuses_other_variants(kw, key):
    """Carried since the libraries are derived from the workload: the
    variant's own library, its key stable and its compile-time shape the
    workload's, where no registered library fits."""
    wl = t_make(**kw)
    spec = fused.kernel_model(wl)
    assert spec.key == key and spec.key not in fused.MODELS
    assert spec.shape == fused.workload_shape(wl) and spec == fused.derive_model(wl)
