"""The farm and the profiler on the card, each test marked ``cuda`` and
skipped without a card. The file imports no JAX, so it runs on the card:
``python -m pytest -m cuda --noconftest tests/test_torch_farm_card.py``.

* ``run_pipelined`` and ``run_device``, checkpointing every generation
  under a flight recorder with the profiler on, run their generations
  under ``explore.device.strict_syncs`` (torch's sync-debug mode
  "error"): nothing but the consume point waits for the card. Each
  campaign and its checkpoint equal the blocking run's.
* One generation of ``run_device``, of ``run_pipelined`` and of the
  host driver ``explore.run``, each with a checkpoint and a flight
  recorder, counted by ``obs.prof.count_syncs`` (``torch.profiler``):
  on the two device drivers, under ``strict_syncs`` and
  ``counted_syncs(generations=1)``, the first generation's count is one
  wait (the consume point's event) and no pageable copy, and it is the
  generation record's ``host_syncs``; the second generation is not
  counted (``None``); the host driver reads its sweep's states back to
  the host, so its count is reported, not held to one.
* ``obs.prof.program_cost`` gives the raft library's launch shape at
  pool 64: the occupancy calculator's numbers and nvcc's registers, as
  ``chip_smoke.py``'s ``launch_shape`` and ``base_registers`` read them
  (``engine.fused.kernel_registers``).
"""

import json
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from madsim_tpu_torch import farm, obs
from madsim_tpu_torch.chaos import CrashStorm, FaultPlan, GrayFailure, PauseStorm
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.explore import device as xdev
from madsim_tpu_torch.models import make_raft
from madsim_tpu_torch.obs import prof

NODES = (0, 1, 2, 3, 4)
PLAN = FaultPlan((
    CrashStorm(targets=(1, 2, 3), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
               down_min_ns=50_000_000, down_max_ns=250_000_000),
    PauseStorm(targets=NODES, n=1, t_min_ns=20_000_000, t_max_ns=300_000_000,
               down_min_ns=50_000_000, down_max_ns=200_000_000),
    GrayFailure(targets=NODES, n_links=1),
), name="farm-soak")
CFG = tcore.EngineConfig(pool_size=64, loss_p=0.02)
KW = dict(generations=4, batch=1024, root_seed=7, max_steps=256, cov_words=32,
          invariant=lambda v: v["halted"] | True)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card with -m cuda)")


def _fp(rep):
    return ([(e.id, e.parent, int(e.seed), int(e.trace), e.new_bits) for e in rep.corpus],
            np.asarray(rep.cov_map).tolist(), rep.curve, rep.viol_curve)


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ["blocking", "pipelined"])
def test_cuda_pipelined_dispatch_never_waits_for_the_card(driver, tmp_path):
    """Under ``strict_syncs`` every generation, its dispatch, its consume,
    its checkpoint and the flight recorder's records with the profiler
    on, runs with torch's sync-debug mode "error", the consume point's
    event wait alone exempt; the campaign and its checkpoint equal the
    blocking run's outside the guard."""
    _needs_card()
    wl = make_raft()
    ref_ck = tmp_path / "ref.ckpt"
    ref = xdev.run_device(wl, CFG, PLAN, checkpoint_path=str(ref_ck), **KW)  # builds
    waits = []
    real_wait = xdev._HostCopy.wait

    def wait(self):
        waits.append(torch.cuda.get_sync_debug_mode())
        real_wait(self)

    run = xdev.run_device if driver == "blocking" else farm.run_pipelined
    ck = tmp_path / "c.ckpt"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(xdev._HostCopy, "wait", wait)
        with xdev.strict_syncs(), obs.FlightRecorder(str(tmp_path / "f.jsonl"),
                                                     heartbeat_s=0.0, profile=True) as fr:
            rep = run(wl, CFG, PLAN, telemetry=fr, checkpoint_path=str(ck), **KW)
    assert torch.cuda.get_sync_debug_mode() == 0
    # the guard was on at every consume point
    assert waits == [2] * KW["generations"]
    assert _fp(rep) == _fp(ref) and ck.read_bytes() == ref_ck.read_bytes()


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ["blocking", "pipelined", "host"])
def test_cuda_generation_host_syncs_are_counted(driver, tmp_path):
    """The profiler's count of a generation with a checkpoint and a
    flight recorder (its profiler on): the device drivers' records carry
    it under ``counted_syncs``, one event wait and no pageable copy, for
    the first generation alone under ``generations=1``."""
    _needs_card()
    from madsim_tpu_torch import explore

    wl = make_raft()
    kw = dict(KW, generations=1)
    ck, log = tmp_path / "c.ckpt", tmp_path / "f.jsonl"
    if driver == "host":
        explore.run(wl, CFG, PLAN, device="cuda", **kw)  # builds
        with prof.count_syncs() as sc, obs.FlightRecorder(str(log), heartbeat_s=0.0) as fr:
            explore.run(wl, CFG, PLAN, telemetry=fr, checkpoint_path=str(ck), device="cuda",
                        **kw)
        print(f"host driver, one generation: {sc}")
        assert sc.measured and sc.total >= 1
        return
    xdev.run_device(wl, CFG, PLAN, **kw)  # builds
    kw = dict(KW, generations=2)
    counted = []
    real = prof.count_syncs

    @contextmanager
    def spy():
        with real() as sc:
            counted.append(sc)
            yield sc

    run = xdev.run_device if driver == "blocking" else farm.run_pipelined
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prof, "count_syncs", spy)
        with xdev.strict_syncs(), xdev.counted_syncs(generations=1), \
                obs.FlightRecorder(str(log), heartbeat_s=0.0, profile=True) as fr:
            rep = run(wl, CFG, PLAN, telemetry=fr, checkpoint_path=str(ck), **kw)
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    gens = [r["host_syncs"] for r in recs if r["event"] == "generation"]
    end = next(r for r in recs if r["event"] == "campaign_end")
    print(f"{driver}: {counted}")
    assert rep.host_syncs == kw["generations"] and len(counted) == 1
    assert all(sc.measured and (sc.syncs, sc.pageable) == (1, 0) for sc in counted)
    assert gens == [counted[0].total, None] == [1, None] and end["host_syncs"] is None


@pytest.mark.cuda
def test_cuda_program_cost_is_the_launch_shape():
    _needs_card()
    spec = fused.kernel_model(make_raft())
    cost = prof.program_cost(spec, 64)
    occ = fused.KERNEL.occupancy(spec, 64)
    assert {k: cost[k] for k in occ} == occ
    want = fused.kernel_registers(fused.build_library(spec)[1], 64)
    assert cost["registers"] == want and set(want) == {"run(metrics=False)",
                                                       "run(metrics=True)", "drain"}
    assert min(occ["run_blocks_per_sm"], occ["drain_blocks_per_sm"]) >= 1
