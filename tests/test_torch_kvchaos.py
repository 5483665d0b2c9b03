"""kvchaos (replicated KV under kill/restart chaos), with and without
the payload arena, in the torch port against the JAX package and the
C++ oracle (oracle id 4), and its two device handler sets
(csrc/model_kvchaos.cuh, KvChaosModel<false> and <true>) built for the
host against the plain step. These runs go through the engine's kill
and restart: the epoch bump, the volatile reset and the restart's
re-init emit; the payload variant moves ev_pay and folds it into the
trace. Exact equality."""

import numpy as np
import pytest

from madsim_tpu.models import make_kvchaos as j_make
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.models import BENCH_SPECS
from madsim_tpu_torch.models import make_kvchaos as t_make

from _torch_host import assert_host_matches_plain, build_host_kernel
from _torch_parity import (
    assert_bench_spec_equal, assert_oracle_traces, assert_workload_equal,
    needs_oracle, run_both,
)

_F, KW, _N, CAP = BENCH_SPECS["kvchaos"]
SEEDS = np.arange(64, dtype=np.uint64) * np.uint64(7919)
MID = 100  # fixed steps: a third of the way to the last halt
PAYLOAD = pytest.mark.parametrize("payload", [False, True], ids=["plain", "payload"])


def test_bench_spec_and_workload_equal_reference():
    assert_bench_spec_equal("kvchaos")
    for payload in (False, True):
        assert_workload_equal(j_make(payload=payload), t_make(payload=payload))
        wl = t_make(payload=payload)
        assert fused.workload_shape(wl) == fused.MODELS[wl.name].shape


@PAYLOAD
def test_bench_run_while_matches_reference_per_field(payload):
    t = run_both(j_make(payload=payload), t_make(payload=payload), KW, SEEDS, CAP,
                 until_halted=True)
    assert t["halted"].all() and t["overflow"].sum() == 0
    # every seed killed and restarted one replica: its epoch went up by 2
    assert (t["epoch"][:, 1:5].sum(axis=1) == 2).all()
    assert (t["node_state"][:, 0, 0] == 20).all()
    if payload:
        # the final value words sit on the primary and on every replica
        # that applied the last write
        assert (t["node_state"][:, 0, 4:6] != 0).any()


@PAYLOAD
def test_fixed_steps_mid_run_matches_reference_per_field(payload):
    t = run_both(j_make(payload=payload), t_make(payload=payload), KW, SEEDS, MID,
                 until_halted=False)
    assert t["ev_valid"].any(axis=1).all() and (~t["alive"]).any()
    if payload:
        assert t["ev_pay"].any()


def test_runtime_words_follow_the_factory():
    kw = dict(writes=5, retx_ns=25_000_000, client_retx_ns=70_000_000, payload=True)
    run_both(j_make(**kw), t_make(**kw), KW, SEEDS[:32], CAP, until_halted=True)


@needs_oracle
@PAYLOAD
def test_traces_match_cpp_oracle(payload):
    t = assert_oracle_traces(j_make(payload=payload), t_make(payload=payload), KW, 400)
    assert t["halted"].any()


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("kvchaos")
    return {
        name: build_host_kernel(d, fused.MODELS[name], (KW["pool_size"],))
        for name in ("kvchaos", "kvchaos-payload")
    }


@PAYLOAD
@pytest.mark.parametrize("n_steps,until_halted", [(CAP, True), (MID, False)],
                         ids=["run_while", "fixed"])
def test_host_built_kernel_matches_plain_step(host_libs, payload, n_steps, until_halted):
    wl = t_make(payload=payload)
    want = assert_host_matches_plain(host_libs[wl.name], wl, tcore.EngineConfig(**KW),
                                     SEEDS[:48], n_steps, until_halted)
    assert want["epoch"].max() >= 1


@pytest.mark.parametrize("kw", [dict(army=True)], ids=["army"])
def test_unported_modes_raise(kw):
    """The army variant waited for the latency markers; it builds now,
    and at the factory's defaults (four replicas, its own chaos) under
    its client army with the latency tap it equals the reference per
    field."""
    from _torch_army import army_only_both

    t = army_only_both("kvchaos", kw, 16, 64, 300, SEEDS[:16])
    assert t["lat_count"].sum() > 0 and t["node_state"].shape[1] == 6


@pytest.mark.parametrize("kw", [dict(record=True), dict(record=True, bug=True)],
                         ids=["record", "bug"])
def test_record_variants_match_reference_per_field(kw):
    """kvchaos-record and kvchaos-bug: the client's write and read
    history, all 80 rows equal; the bug variant's final state is as
    healthy as the clean one's."""
    t = run_both(j_make(**kw), t_make(**kw), KW, SEEDS[:16], CAP, until_halted=True)
    assert t["halted"].all() and (t["node_state"][:, 0, 0] == 20).all()
    assert t["hist_word"].shape == (16, 80, 5) and (t["hist_count"] > 40).all()
    with pytest.raises(ValueError, match="requires record=True"):
        t_make(bug=True)


@pytest.mark.parametrize("kw,key", [(dict(chaos=False), "kvchaos-nochaos"),
                                    (dict(n_replicas=3), "kvchaos-r3")],
                         ids=["no_chaos", "three_replicas"])
def test_kernel_refuses_other_variants(kw, key):
    """Carried since the libraries are derived from the workload: the
    variant's own library, its key stable and its compile-time shape the
    workload's, where no registered library fits."""
    wl = t_make(**kw)
    spec = fused.kernel_model(wl)
    assert spec.key == key and spec.key not in fused.MODELS
    assert spec.shape == fused.workload_shape(wl) and spec == fused.derive_model(wl)
