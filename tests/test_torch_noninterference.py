"""madsim_tpu_torch.lint.noninterference: the derived-state manifest and
the column contracts against the JAX package's; the perturbation check
through the plain step and through the run kernel's step code built with
g++; the planted ``met`` leak; the plain step from a perturbed state
against the JAX engine; the report's JSON form."""

import _torch_threads  # noqa: F401
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import madsim_tpu.engine as je
import madsim_tpu.engine.core as jcore
import madsim_tpu.models as jm
import madsim_tpu_torch.models as tm
from madsim_tpu_torch.chaos import CrashStorm, FaultPlan
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.lint import cli
from madsim_tpu_torch.lint.noninterference import (
    BUILD_AXES,
    NonInterferenceReport,
    check_matrix,
    check_noninterference,
    model_matrix,
    perturb_derived,
    plant_met_leak,
)

from _torch_host import build_host_kernel, host_run
from _torch_parity import assert_same_state

POOL_FIELDS = ("tile_min", "tile_cnt")
SEEDS = np.arange(16, dtype=np.uint64)
MATRIX = {tag: (wl, cfg) for tag, wl, cfg, _h in model_matrix()}
HORIZON = {tag: h for tag, _wl, _cfg, h in model_matrix()}
J_MATRIX = {tag: (wl, kw) for mod in (jm.raft, jm.kvchaos, jm.paxos, jm.raftlog, jm.leasekv,
                                      jm.shardkv) for tag, wl, kw in mod.lint_entries()}


@pytest.mark.parametrize("tag", list(MATRIX))
def test_manifest_and_contracts_are_the_jax_packages(tag):
    wl, cfg = MATRIX[tag]
    jwl, jkw = J_MATRIX[tag]
    assert cfg == tcore.EngineConfig(**jkw) and wl.delay_bound_ns == jwl.delay_bound_ns
    assert tcore.derived_fields(wl) == jcore.derived_fields(jwl)
    assert tcore.core_fields(wl) == tuple(f for f in jcore.core_fields(jwl)
                                          if f not in POOL_FIELDS)
    mod = getattr(tm, tag.split("/")[0])
    jmod = getattr(jm, tag.split("/")[0])
    assert mod.ABSINT_HORIZON_NS == jmod.ABSINT_HORIZON_NS == HORIZON[tag]
    for horizon in (None, mod.ABSINT_HORIZON_NS):
        got = tcore.column_contracts(wl, cfg, horizon_ns=horizon)
        want = jcore.column_contracts(jwl, je.EngineConfig(**jkw), horizon_ns=horizon)
        assert set(want) - set(got) == set(POOL_FIELDS)
        for f, c in got.items():
            w = want[f]
            assert (c.field, c.lo, c.hi, c.family, c.note) == (w.field, w.lo, w.hi,
                                                               w.family, w.note), f


@pytest.mark.parametrize("name", ["raft", "microbench", "pingpong", "broadcast", "kvchaos",
                                  "raftlog", "snapshot", "twophase", "paxos", "leasekv",
                                  "shardkv"])
def test_every_family_declares_the_jax_packages_bounds(name):
    twl, jwl = getattr(tm, f"make_{name}")(), getattr(jm, f"make_{name}")()
    assert twl.delay_bound_ns == jwl.delay_bound_ns
    assert (twl.state_contracts is None) == (jwl.state_contracts is None)
    for a, b in zip(twl.state_contracts or (), jwl.state_contracts or ()):
        assert (a.col, a.lo, a.hi, a.family) == (b.col, b.lo, b.hi, b.family)


@pytest.mark.parametrize("tag,axis", cli.SMOKE, ids=[t for t, _a in cli.SMOKE])
def test_the_plain_step_keeps_derived_state_out_of_the_trajectory(tag, axis):
    wl, cfg = MATRIX[tag]
    [rep] = check_matrix([(tag, axis)], seeds=SEEDS, n_steps=120, device="cpu")
    assert rep.ok, rep.summary()
    assert rep.flags["axis"] == axis and rep.n_seeds == len(SEEDS)
    assert rep.horizon_ns == HORIZON[tag] and f"{HORIZON[tag] / 1e9:g} s" in rep.summary()
    assert rep.entry == "make_run_plain" and rep.chunks == 4 and not rep.uncertified
    if axis == "all":
        assert {"met", "cov", "cov_hits", "tl_t", "ev_parent", "lat_inv",
                "hist_word"} <= set(rep.derived)
    if tag == "raftlog/durable":
        assert "disk" in tcore.core_fields(wl) and "disk" not in rep.derived


def test_the_planted_met_leak_is_reported_as_step():
    wl, cfg = MATRIX["raft/record"]

    def leaky(*a, **k):
        return plant_met_leak(tcore.make_run_plain(*a, **k))

    rep = check_noninterference(wl, cfg, run=leaky, seeds=SEEDS[:8], n_steps=40,
                                device="cpu", metrics=True)
    assert not rep.ok and "step" in rep.diffs
    assert rep.diffs["step"]["chunk"] == 0 and rep.diffs["step"]["seeds"] > 0
    assert "LEAK" in rep.summary() and "'step'" in rep.summary()
    # a perturbed core column is a live control too
    rep = check_noninterference(wl, cfg, seeds=SEEDS[:8], n_steps=40, device="cpu",
                                fields=("seed",))
    assert "trace" in rep.diffs and "seed" in rep.diffs


def test_the_report_survives_a_json_round_trip():
    wl, cfg = MATRIX["raft/plain"]
    rep = check_noninterference(wl, cfg, seeds=SEEDS[:4], n_steps=8, chunks=2,
                                device="cpu", **BUILD_AXES["latency"])
    back = NonInterferenceReport.from_dict(json.loads(rep.to_json()))
    assert back == rep and back.to_json() == rep.to_json() and back.ok


def test_check_matrix_refuses_a_cell_it_does_not_know():
    for cells in ([("raft/none", "base")], [("raft/plain", "none")], []):
        with pytest.raises(ValueError, match="not \\(tag, axis\\) pairs"):
            check_matrix(cells, seeds=SEEDS, n_steps=8, device="cpu")


def _host_runner(lib):
    def host(wl, cfg, n, latency=None, retry=None, **_flags):
        return lambda st: host_run(lib, wl, cfg, st, n, False, latency=latency, retry=retry)

    return host


@pytest.fixture(scope="module")
def raft_lib(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp("ni_raft"), fused.MODELS["raft"], (40,),
                             obs=True)


@pytest.fixture(scope="module")
def kv_lib(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp("ni_kv"),
                             fused.MODELS["kvchaos-bug-nochaos"], (192,), obs=True)


def test_the_host_built_kernel_on_raft_with_every_tap(raft_lib):
    wl, cfg = tm.make_raft(), tcore.EngineConfig(pool_size=40, loss_p=0.02)
    taps = dict(metrics=True, cov_words=8, cov_hitcount=True, timeline_cap=16, causal=True)
    rep = check_noninterference(wl, cfg, run=_host_runner(raft_lib), seeds=SEEDS,
                                n_steps=120, device="cpu", **taps)
    assert rep.ok, rep.summary()
    assert {"cov_hits", "tl_count", "ev_emit", "lam", "met"} <= set(rep.derived)


def test_the_host_built_kernel_on_kvchaos_with_the_causal_axis(kv_lib):
    wl = tm.make_kvchaos(writes=10, record=True, bug=True, chaos=False)
    cfg = tcore.EngineConfig(pool_size=192, loss_p=0.05)
    assert fused.kernel_model(wl).key == "kvchaos-bug-nochaos"
    plan = FaultPlan((CrashStorm(targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000,
                                 t_max_ns=400_000_000, down_min_ns=50_000_000,
                                 down_max_ns=250_000_000),), name="kv-nemesis")
    taps = dict(metrics=True, cov_words=8, timeline_cap=16, causal=True)
    seeds = SEEDS[:8] * np.uint64(37)
    st = tcore.make_init(wl, cfg, device="cpu", plan_slots=plan.slots, **taps)(
        seeds, plan.compile_batch(seeds, wl=wl))
    rep = check_noninterference(wl, cfg, run=_host_runner(kv_lib), seeds=st, n_steps=120,
                                **taps)
    assert rep.ok, rep.summary()
    assert {"ev_parent", "tl_parent", "hist_count", "hist_word"} <= set(rep.derived)


def test_the_plain_step_from_a_perturbed_state_is_the_jax_engines():
    wl, cfg = MATRIX["raft/record"]
    jwl, jkw = J_MATRIX["raft/record"]
    taps = BUILD_AXES["all"]
    st = tcore.make_init(wl, cfg, device="cpu", **taps)(SEEDS[:8])
    st = tcore.make_run_plain(wl, cfg, 20, **taps)(st)
    gen = torch.Generator().manual_seed(5)
    st = perturb_derived(st, tcore.derived_fields(wl), tcore.column_contracts(wl, cfg), gen)
    jtaps = {**taps, "latency": je.LatencySpec(ops=8, phases=2)}
    js = je.make_init(jwl, je.EngineConfig(**jkw), time32=False, **jtaps)(SEEDS[:8])
    js = dataclasses.replace(js, **{f: jnp.asarray(v) for f, v in state_to_numpy(st).items()})
    assert_same_state(js, st)
    jo = jax.jit(je.make_run(jwl, je.EngineConfig(**jkw), 60, layout="scatter", time32=False,
                             pool_index=False, **jtaps))(js)
    to = tcore.make_run_plain(wl, cfg, 60, **taps)(st)
    assert_same_state(jo, to)


def test_the_check_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl, cfg = MATRIX["raft/plain"]
    with pytest.raises(RuntimeError, match="CUDA"):
        check_noninterference(wl, cfg, seeds=SEEDS[:2], n_steps=4)
