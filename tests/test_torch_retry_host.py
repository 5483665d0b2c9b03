"""The run kernel's client-retry timers against the port's plain step:
the two libraries of the retry soak, ``kvchaos-record-army-r2-nochaos``
and ``shardkv-noidem-army-nochaos`` at pool 96, built for the host with
g++ (``tests/_torch_host.py``) and run under the soak's policied plans,
with and without the fleet counters, every field equal (the three retry
columns and all 18 counters included). Also: a retry run at a shape or
pool without a library raises instead of running the plain step. No
JAX here."""

import _torch_threads  # noqa: F401

import numpy as np
import pytest

from madsim_tpu_torch import chaos as tchaos
from madsim_tpu_torch import models as tmodels
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy

from _torch_host import build_host_kernel, host_run

SEEDS = np.arange(12, dtype=np.uint64) * np.uint64(7919)


def _kv():
    pol = tchaos.RetryPolicy(timeout_ns=50_000_000, max_attempts=3, backoff_base_ns=10_000_000,
                             backoff_mult=2.0, jitter=0.5)
    plan = tchaos.FaultPlan((
        tmodels.kvchaos.client_army(n_ops=16, t_min_ns=5_000_000, t_max_ns=280_000_000,
                                    n_replicas=2, retry=pol),
        tchaos.GrayFailure(targets=(0, 3), n_links=1, mult_min=6, mult_max=12),
    ), name="kv-retry-gray")
    return (tmodels.make_kvchaos(writes=12, n_replicas=2, chaos=False, army=True, record=True),
            tcore.EngineConfig(pool_size=96, time_limit_ns=450_000_000,
                               clog_backoff_max_ns=2_000_000_000),
            plan, tcore.LatencySpec(ops=16, phases=3, phase_ns=1 << 27))


def _sk():
    pol = tchaos.RetryPolicy(timeout_ns=8_000_000, max_attempts=3, backoff_base_ns=4_000_000,
                             backoff_mult=2.0, jitter=0.25)
    plan = tchaos.FaultPlan((
        tmodels.shardkv.client_army(n_ops=16, t_min_ns=5_000_000, t_max_ns=280_000_000,
                                    retry=pol),
        tchaos.GrayFailure(targets=(0, 1), n_links=1, mult_min=8, mult_max=16),
    ), name="sk-noidem-hunt")
    return (tmodels.make_shardkv(record=True, chaos=False, army=True, bug="noidem"),
            tcore.EngineConfig(pool_size=96, time_limit_ns=600_000_000), plan,
            tcore.LatencySpec(ops=16))


CASES = {"kvchaos-record-army-r2-nochaos": _kv, "shardkv-noidem-army-nochaos": _sk}


@pytest.mark.parametrize("key", sorted(CASES))
@pytest.mark.parametrize("metrics", [True, False], ids=["metrics", "plain"])
def test_host_built_retry_kernel_matches_the_plain_step(tmp_path_factory, key, metrics):
    wl, cfg, plan, lat = CASES[key]()
    spec = fused.kernel_model(wl)
    assert spec.key == key
    lib = build_host_kernel(tmp_path_factory.mktemp(key), spec, (cfg.pool_size,))
    rt = plan.retry_spec()
    st = tcore.make_init(wl, cfg, device="cpu", plan_slots=plan.slots, latency=lat,
                         metrics=metrics, retry=rt)(SEEDS, plan.compile_batch(SEEDS, wl=wl))
    want = state_to_numpy(tcore.make_run_while_plain(wl, cfg, 3000, metrics=metrics, latency=lat,
                                                     retry=rt)(st))
    got = state_to_numpy(host_run(lib, wl, cfg, st, 3000, True, latency=lat, retry=rt))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert want["rt_done"].any() and want["rt_deadline"].any()
    if metrics:
        assert want["met"][:, tcore.MET_RETRY].sum() > 0


def test_retry_runs_without_a_library_raise():
    """Another shape of the army has no library, and a library at a pool
    it was not built for refuses the state, retry or no retry."""
    other = tmodels.make_kvchaos(writes=12, n_replicas=3, chaos=False, army=True, record=True)
    spec = fused.kernel_model(other)
    assert spec.key == "kvchaos-record-army-nochaos-r3" and spec.lat == 1
    wl, cfg, plan, lat = _kv()
    bad = tcore.EngineConfig(pool_size=128, time_limit_ns=450_000_000)
    st = tcore.make_init(wl, bad, device="cpu", plan_slots=plan.slots, latency=lat,
                         retry=plan.retry_spec())(SEEDS[:2], plan.compile_batch(SEEDS[:2], wl=wl))
    with pytest.raises(ValueError, match="CUDA"):
        fused.check_state(fused.kernel_model(wl), wl, st)
    assert fused.library_at(fused.kernel_model(wl), 128).key == (
        "kvchaos-record-army-r2-nochaos-p128")
    with pytest.raises(ValueError, match="retry columns for 16 ops"):
        fused.check_taps(st, False, latency=lat)
