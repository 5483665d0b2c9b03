"""The JAX package's full-surface step goldens, reproduced by the torch
port: the five scenarios of ``tools/step_goldens.py`` (``scenarios()``:
32 seeds, 240 steps, every observability tap, latency, and army plans
for raftlog and kvchaos) through the port's plain step and its
compacted runner on the CPU, each digested by the tool's own
``digest_state`` over the JAX package's field names, order and dtypes,
must equal ``tests/_step_goldens.py``. ``chip_smoke.py`` holds its copy
of the two army scenarios' digests to the same values through the run
kernel on the card."""

import _torch_threads  # noqa: F401
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import madsim_tpu.engine as je
from madsim_tpu_torch import chaos as tchaos
from madsim_tpu_torch import models as tmodels
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.compact import make_run_compacted
from madsim_tpu_torch.engine.convert import state_to_numpy

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

import step_goldens  # noqa: E402

from _step_goldens import GOLDENS  # noqa: E402

import chip_smoke  # noqa: E402

# the JAX package's SimState, field for field, to hand the port's state
# to digest_state in the reference's order
JaxOrder = dataclasses.make_dataclass(
    "JaxOrder", [f.name for f in dataclasses.fields(je.SimState)])


def jax_order(fields: dict):
    """The port's fields (numpy, the JAX dtypes) in the JAX package's
    field order; the fields the port does not carry are those the digest
    skips."""
    return JaxOrder(**{f.name: fields.get(f.name, np.zeros(0))
                       for f in dataclasses.fields(je.SimState)})


def _army_plan(army_fn, n_ops, servers):
    return tchaos.FaultPlan((
        army_fn(n_ops=n_ops, t_min_ns=5_000_000, t_max_ns=400_000_000),
        tchaos.CrashStorm(targets=servers, n=1, t_min_ns=50_000_000, t_max_ns=200_000_000,
                          down_min_ns=20_000_000, down_max_ns=80_000_000),
        tchaos.GrayFailure(targets=servers, n_links=1, mult_min=4, mult_max=8,
                           t_min_ns=30_000_000, t_max_ns=150_000_000,
                           dur_min_ns=50_000_000, dur_max_ns=150_000_000),
    ))


def port_scenarios() -> dict:
    """tools/step_goldens.py ``scenarios()`` built with the port."""
    kw = dict(loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
    lat10 = tcore.LatencySpec(ops=10, phases=3, phase_ns=1 << 27)
    servers = tuple(range(5))
    return {
        "raftlog/army-obs": (tmodels.make_raftlog(record=True, army=True),
                             tcore.EngineConfig(pool_size=96, **kw),
                             _army_plan(tmodels.raftlog.client_army, 10, servers), lat10),
        "raftlog/durable-obs": (tmodels.make_raftlog(record=True, durable=True),
                                tcore.EngineConfig(pool_size=64, **kw), None,
                                tcore.LatencySpec(ops=4)),
        "kvchaos/army-obs": (tmodels.make_kvchaos(record=True, army=True, army_probes=2),
                             tcore.EngineConfig(pool_size=72, **kw),
                             _army_plan(tmodels.kvchaos.client_army, 10, servers), lat10),
        "raft/record-obs": (tmodels.make_raft(record=True), tcore.EngineConfig(pool_size=40, **kw),
                            None, tcore.LatencySpec(ops=4)),
        "paxos/record-obs": (tmodels.make_paxos(record=True),
                             tcore.EngineConfig(pool_size=48, **kw), None,
                             tcore.LatencySpec(ops=4)),
    }


@pytest.fixture(scope="module")
def digests():
    """Each scenario through the port's plain step and its compacted
    runner (``min_size=8``, the tool's), digested; every scenario's
    config, plan and spec are the tool's."""
    want = step_goldens.scenarios()
    out = {}
    seeds = np.arange(step_goldens.N_SEEDS, dtype=np.uint64)
    for name, (wl, cfg, plan, lat) in port_scenarios().items():
        jwl, jcfg, jplan, jlat = want[name]
        assert cfg.hash() == jcfg.hash() and (wl.name, wl.n_nodes) == (jwl.name, jwl.n_nodes)
        assert (plan is None) == (jplan is None) and (plan is None or plan.hash() == jplan.hash())
        assert dataclasses.astuple(lat) == dataclasses.astuple(jlat)
        slots = plan.slots if plan is not None else 0
        init = tcore.make_init(wl, cfg, device="cpu", plan_slots=slots, latency=lat,
                               **step_goldens.OBS)
        st0 = init(seeds, plan.compile_batch(seeds, wl=wl)) if plan is not None else init(seeds)
        run = tcore.make_run(wl, cfg, step_goldens.N_STEPS, latency=lat, **step_goldens.OBS)
        out[name] = step_goldens.digest_state(jax_order(state_to_numpy(run(st0))))
        co = make_run_compacted(wl, cfg, step_goldens.N_STEPS, latency=lat, min_size=8,
                                **step_goldens.OBS)(st0)
        out[f"{name}/compact"] = step_goldens.digest_state(co)
    return out


@pytest.mark.parametrize("key", sorted(GOLDENS))
def test_the_port_reproduces_the_step_golden(digests, key):
    assert digests[key] == GOLDENS[key], f"{key}: the port's step drifted from the reference"


def test_chip_smoke_holds_the_army_goldens_the_same_way(digests):
    """chip_smoke.py's copy of the army digests, its field order and its
    digest function are the tool's; its scenarios are the tool's."""
    assert chip_smoke.ARMY_GOLDENS == {k: GOLDENS[k] for k in chip_smoke.ARMY_GOLDENS}
    assert set(chip_smoke.ARMY_GOLDENS) == {
        k for k in GOLDENS if k.split("/")[1] == "army-obs"}
    skip = (set(je.POOL_INDEX_STATE_FIELDS) | set(je.CAUSAL_STATE_FIELDS)
            | set(je.RETRY_STATE_FIELDS))
    assert chip_smoke.GOLDEN_FIELDS == tuple(
        f.name for f in dataclasses.fields(je.SimState) if f.name not in skip)
    assert chip_smoke.GOLDEN_MET_SLOTS == je.MET_RETRY
    assert set(chip_smoke.GOLDEN_SKIP) == skip & set(tcore.STATE_FIELDS)
    assert (chip_smoke.GOLDEN_SEEDS, chip_smoke.GOLDEN_STEPS, chip_smoke.GOLDEN_OBS) == (
        step_goldens.N_SEEDS, step_goldens.N_STEPS, step_goldens.OBS)
    want = step_goldens.scenarios()
    seeds = np.arange(step_goldens.N_SEEDS, dtype=np.uint64)
    for name, (wl, cfg, plan, lat) in chip_smoke.golden_scenarios().items():
        _jwl, jcfg, jplan, jlat = want[name]
        assert (cfg.hash(), plan.hash(), dataclasses.astuple(lat)) == (
            jcfg.hash(), jplan.hash(), dataclasses.astuple(jlat))
        st = tcore.make_init(wl, cfg, device="cpu", plan_slots=plan.slots, latency=lat,
                             **chip_smoke.GOLDEN_OBS)(seeds, plan.compile_batch(seeds, wl=wl))
        out = tcore.make_run(wl, cfg, 3, latency=lat, **chip_smoke.GOLDEN_OBS)(st)
        fields = state_to_numpy(out)
        assert chip_smoke.golden_digest(fields, chip_smoke.GOLDEN_FIELDS) == \
            step_goldens.digest_state(jax_order(fields))
        # and a compacted run's banks, as phase 45 digests them
        co = make_run_compacted(wl, cfg, 3, latency=lat, min_size=8,
                                **chip_smoke.GOLDEN_OBS)(st)
        names = [f for f in sorted(vars(co)) if f not in chip_smoke.GOLDEN_SKIP]
        assert chip_smoke.golden_digest(vars(co), names) == step_goldens.digest_state(co)
