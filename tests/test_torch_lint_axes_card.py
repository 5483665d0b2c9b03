"""The lint's campaign, flight and check axes through the run kernel, and
the two taps builds the soaks' hunts need, on the card. Each test is
marked ``cuda`` and skips without a card. The file imports no JAX, so it
runs on the card:
``python -m pytest -m cuda --noconftest tests/test_torch_lint_axes_card.py``.

* ``lint.check_campaign`` with sharded-causal's flags on
  kvchaos-bug-nochaos at pool 192 (a crash storm, 2 x 64): the children
  through ``engine.make_run`` (the run kernel) and the campaign's outcome
  under perturbation, the controls reported;
* the same with flight-campaign's flags on kvchaos-army-nochaos at pool
  160 under its army, inside a ``FlightRecorder`` with its profiler on,
  each counted generation one wait;
* ``check_noninterference`` with device-check's flags on
  raftlog-nosync-record at pool 128 under the store soak's plan, judged
  by election and recovery safety on the card;
* raftlog-nosync-record at 128 and kvchaos-army-nochaos at 160 have the
  taps build: the occupancy calculator's launch shape, and one run with
  every tap equal to the plain step on the CPU.
"""

import numpy as np
import pytest
import torch

from madsim_tpu_torch.chaos import CrashStorm, DiskFault, FaultPlan, FlappingPartition
from madsim_tpu_torch.chaos import GrayFailure
from madsim_tpu_torch.check import device as dc
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.lint import (
    CAMPAIGN_AXES,
    CHECK_AXES,
    FLIGHT_AXES,
    check_campaign,
    check_noninterference,
    screens_verdict,
)
from madsim_tpu_torch.models import kvchaos, raftlog

NODES = (0, 1, 2, 3, 4)
RUN = dict(generations=2, batch=64, root_seed=7)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card with -m cuda)")


def _store():
    wl = raftlog.make_raftlog(record=True, chaos=False, durable=True, bug="nosync")
    cfg = tcore.EngineConfig(pool_size=128, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
    plan = FaultPlan((
        CrashStorm(targets=NODES, n=2, t_min_ns=150_000_000, t_max_ns=500_000_000,
                   down_min_ns=100_000_000, down_max_ns=400_000_000),
        FlappingPartition(targets=NODES, n_cycles=2, t_min_ns=50_000_000,
                          t_max_ns=400_000_000, dur_min_ns=100_000_000,
                          dur_max_ns=300_000_000, up_min_ns=20_000_000, up_max_ns=200_000_000),
        DiskFault(targets=NODES, n_torn=2, t_min_ns=50_000_000, t_max_ns=500_000_000),
    ), name="store-hunt")
    return wl, cfg, plan, 6000


def _army():
    wl = kvchaos.make_kvchaos(writes=20, n_replicas=2, chaos=False, army=True, army_probes=3)
    cfg = tcore.EngineConfig(pool_size=160, time_limit_ns=700_000_000)
    plan = FaultPlan((
        kvchaos.client_army(n_ops=64, t_min_ns=5_000_000, t_max_ns=500_000_000, n_replicas=2),
        GrayFailure(targets=(0, 1, 2, 3), n_links=1, mult_min=4, mult_max=12,
                    t_min_ns=20_000_000, t_max_ns=600_000_000, dur_min_ns=50_000_000,
                    dur_max_ns=80_000_000),
    ), name="slo-hunt")
    return wl, cfg, plan, 4000


@pytest.mark.cuda
def test_cuda_campaign_axis_through_the_run_kernel():
    _needs_card()
    wl = kvchaos.make_kvchaos(writes=10, record=True, bug=True, chaos=False)
    cfg = tcore.EngineConfig(pool_size=192, loss_p=0.05)
    plan = FaultPlan((CrashStorm(targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000,
                                 t_max_ns=400_000_000, down_min_ns=50_000_000,
                                 down_max_ns=250_000_000),), name="kv-nemesis")
    fused.KERNEL.reset()
    rep = check_campaign(wl, cfg, plan, history_check=(dc.stale_reads(), dc.read_your_writes()),
                         max_steps=4000, horizon_ns=kvchaos.ABSINT_HORIZON_NS, **RUN,
                         **CAMPAIGN_AXES["sharded-causal"])
    assert rep.ok, rep.summary()
    assert fused.KERNEL.counts.get("kvchaos-bug-nochaos", 0) > 0
    assert rep.controls["guidance"]["live"] and rep.controls["met-leak"]["live"]


@pytest.mark.cuda
def test_cuda_flight_axis_through_the_run_kernel():
    _needs_card()
    wl, cfg, plan, steps = _army()
    fused.KERNEL.reset()
    rep = check_campaign(wl, cfg, plan, invariant=lambda v: v["halted"], max_steps=steps,
                         horizon_ns=kvchaos.ABSINT_HORIZON_NS, **RUN,
                         **FLIGHT_AXES["flight-campaign"])
    assert rep.ok, rep.summary()
    f = rep.parts["flight"]
    assert f["equal"] and f["host_syncs"] and all(h == 1 for h in f["host_syncs"])
    assert fused.KERNEL.counts.get("kvchaos-army-nochaos", 0) > 0


@pytest.mark.cuda
def test_cuda_check_axis_through_the_run_kernel():
    _needs_card()
    wl, cfg, plan, steps = _store()
    flags = CHECK_AXES["device-check"]
    seeds = np.arange(1024, dtype=np.uint64)
    st = tcore.make_init(wl, cfg, device="cuda", plan_slots=plan.slots,
                         **{k: v for k, v in flags.items() if k != "check"})(
        seeds, plan.compile_batch(seeds, wl=wl))
    screens = (dc.election_safety(raftlog.OP_COMMIT), dc.election_safety(raftlog.OP_ELECT),
               dc.recovery_safety(raftlog.OP_SYNCED, raftlog.OP_RECOVER))
    fused.KERNEL.reset()
    rep = check_noninterference(wl, cfg, run=tcore.make_run, seeds=st, n_steps=steps,
                                horizon_ns=raftlog.ABSINT_HORIZON_NS,
                                verdict=screens_verdict(screens), **flags)
    assert rep.ok, rep.summary()
    assert rep.controls["verdict"]["live"]
    assert fused.KERNEL.counts.get("raftlog-nosync-record", 0) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["raftlog-nosync-record", "kvchaos-army-nochaos"])
def test_cuda_the_new_taps_builds_report_their_shapes_and_match_the_cpu(case):
    _needs_card()
    wl, cfg, plan, steps = _store() if case == "raftlog-nosync-record" else _army()
    spec = fused.kernel_model(wl)
    assert spec.key == case and cfg.pool_size in spec.obs_pools
    shape = fused.KERNEL.occupancy(spec, cfg.pool_size)
    assert min(shape["run_blocks_per_sm"], shape["met_blocks_per_sm"],
               shape["drain_blocks_per_sm"]) >= 1 and shape["seeds_per_block"] >= 1
    taps = dict(cov_words=64, timeline_cap=256, metrics=True)
    lat = tcore.LatencySpec(ops=64, phases=2, phase_ns=1 << 28) if spec.lat else None
    if lat is not None:
        taps["latency"] = lat
    seeds = np.arange(64, dtype=np.uint64)
    st = tcore.make_init(wl, cfg, device="cpu", plan_slots=plan.slots, **taps)(
        seeds, plan.compile_batch(seeds, wl=wl))
    fused.KERNEL.reset()
    got = tcore.make_run_while(wl, cfg, steps, **taps)(st.to("cuda"))
    assert fused.KERNEL.counts.get(case) == 1
    want = state_to_numpy(tcore.make_run_while_plain(wl, cfg, steps, **taps)(st))
    got = state_to_numpy(got)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
