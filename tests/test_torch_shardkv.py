"""shardkv (sharded KV with key-range migration under primary-crash
chaos, default variant) in the torch port against the JAX package, and
its device handlers (csrc/model_shardkv.cuh) built for the host against
the plain step. Fourteen nodes, seventeen state words, a non-zero
initial state and every column durable: a restart keeps the whole row.
The C++ oracle does not cover this family, so the halted state is also
held to the migration protocol's own invariant. Exact equality."""

import numpy as np
import pytest

from madsim_tpu.models import make_shardkv as j_make
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.models import SOAK_SPECS
from madsim_tpu_torch.models import make_shardkv as t_make

from _torch_host import assert_host_matches_plain, build_host_kernel
from _torch_parity import assert_soak_spec, assert_workload_equal, run_both

NAME = "shardkv"
_F, KW, _N, CAP = SOAK_SPECS[NAME]
SEEDS = np.arange(64, dtype=np.uint64) * np.uint64(7919)
MID = 60  # fixed steps: before the first seed halts
G, R, S = 4, 3, 8


def _no_lost_shard(t, writes=16):
    """At halt the primary of the group the controller assigns each
    shard to owns it, at the version of the shard's last write. The
    restarted primary keeps the shards it owns only because its row is
    durable."""
    ns = t["node_state"]
    rows = np.arange(len(ns))
    for s in range(S):
        word = ns[:, 0, 4] if s < 4 else ns[:, 0, 5]
        primary = 2 + ((word >> ((s & 3) * 4)) & 0xF) * R
        assert (ns[rows, primary, S + s] > 0).all(), s
        last = max(k for k in range(1, writes + 1) if k % S == s)
        assert (ns[rows, primary, s] == last).all(), s


def test_soak_spec_and_workload_equal_reference():
    b2 = dict(clog_backoff_max_ns=2_000_000_000)
    assert_soak_spec(NAME, t_make, {}, dict(pool_size=64, loss_p=0.02, **b2), 4096, 6000)
    assert_workload_equal(j_make(), t_make())
    assert fused.workload_shape(t_make()) == fused.MODELS[NAME].shape
    assert t_make().initial_state().any() and not t_make().volatile_mask().any()


def test_soak_run_while_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, CAP, until_halted=True)
    assert t["halted"].all() and t["overflow"].sum() == 0
    _no_lost_shard(t)
    # every seed's primary crash came before the halt
    restarted = t["epoch"].sum(1) == 2
    assert restarted.all()


def test_fixed_steps_mid_run_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, MID, until_halted=False)
    assert t["ev_valid"].any(axis=1).all() and not t["halted"].any()


WORDS = dict(writes=8, n_migs=6, put_ms=15, mig_ms=50, retx_ms=30)


def test_runtime_words_follow_the_factory(host_lib):
    t = run_both(j_make(**WORDS), t_make(**WORDS), KW, SEEDS[:32], CAP,
                 until_halted=True)
    assert t["halted"].all() and (t["node_state"][:, 0, 6] == 6).all()
    assert_host_matches_plain(host_lib, t_make(**WORDS), tcore.EngineConfig(**KW),
                              SEEDS[:32], CAP, True)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp(NAME), fused.MODELS[NAME],
                             (KW["pool_size"],))


@pytest.mark.parametrize("n_steps,until_halted", [(CAP, True), (MID, False), (150, False)],
                         ids=["run_while", "fixed", "fixed_past_restarts"])
def test_host_built_kernel_matches_plain_step(host_lib, n_steps, until_halted):
    want = assert_host_matches_plain(host_lib, t_make(), tcore.EngineConfig(**KW),
                                     SEEDS[:48], n_steps, until_halted)
    if n_steps > MID:
        # the all-durable restart ran: the re-init kept the reborn rows
        assert (want["epoch"].sum(1) == 2).any()


@pytest.mark.parametrize("kw", [dict(army=True), dict(record=True, bug="noidem", army=True)],
                         ids=["army", "noidem"])
def test_unported_modes_raise(kw):
    """army waited for the latency markers and bug="noidem" for the retry
    axis; both build now and, under the client army with the latency tap,
    equal the reference per field (noidem's fault needs a retry policy to
    show: without one every op is delivered once)."""
    from _torch_army import army_only_both

    t = army_only_both("shardkv", kw, 16, 96, 300, SEEDS[:16])
    assert t["lat_count"].sum() > 0
    if kw.get("bug") == "noidem":
        assert t_make(**kw).name == "shardkv-noidem-army"


@pytest.mark.parametrize("kw", [dict(record=True), dict(record=True, bug=True)],
                         ids=["record", "bug"])
def test_record_variants_match_reference_per_field(kw):
    """shardkv-record and shardkv-bug: committed writes and installs,
    all 64 history rows equal."""
    t = run_both(j_make(**kw), t_make(**kw), KW, SEEDS[:16], CAP, until_halted=True)
    assert t["hist_word"].shape == (16, 64, 5) and (t["hist_count"] > 0).all()


@pytest.mark.parametrize("kw,key", [(dict(chaos=False), "shardkv-nochaos"),
                                    (dict(n_groups=3), "shardkv-g3"),
                                    (dict(n_shards=6), "shardkv-s6")],
                         ids=["no_chaos", "three_groups", "six_shards"])
def test_kernel_refuses_other_variants(kw, key):
    """Carried since the libraries are derived from the workload: the
    variant's own library, its key stable and its compile-time shape the
    workload's, where no registered library fits."""
    wl = t_make(**kw)
    spec = fused.kernel_model(wl)
    assert spec.key == key and spec.key not in fused.MODELS
    assert spec.shape == fused.workload_shape(wl) and spec == fused.derive_model(wl)
