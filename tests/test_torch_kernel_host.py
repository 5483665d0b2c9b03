"""The run kernel's step code, built for the host, against the plain step.

``csrc/engine_step.cuh`` and the model headers mark their functions
MADSIM_HD, which is ``__host__ __device__`` under nvcc and nothing under
g++. Here g++ builds them (no torch headers) with a small host entry point
into a ctypes library in a temporary directory, and the library runs the
kernel's exact per-seed loop — load, step or drain, store — over the
port's CPU tensors through the same argument packing the CUDA launch
uses (``tests/_torch_host.py``). This is the CPU evidence of the
kernel's logic for raft; the other models' host builds sit in their own
test files. The tests marked ``cuda`` run the real kernel of every
registered model (the ``BENCH_SPECS`` and ``SOAK_SPECS`` models), and
of the chaos3 test workload, and need a card.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.models import BENCH_SPECS, SOAK_SPECS, make_kvchaos, make_raft

from _torch_chaos3 import CHAOS3_MODEL, CHAOS_CFG, chaos3_spec, chaos3_workload
from _torch_host import build_host_kernel, host_launch, host_run

RAFT_POOLS = (40, 64, 128, 256)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    spec = fused.MODELS["raft-election"]
    return build_host_kernel(tmp_path_factory.mktemp("raft_host"), spec, RAFT_POOLS)


@pytest.mark.parametrize(
    "kw,n_steps,until_halted",
    [
        (dict(pool_size=128, loss_p=0.02), 1, False),
        (dict(pool_size=128, loss_p=0.02), 60, False),
        (BENCH_SPECS["raft"][1], BENCH_SPECS["raft"][3], True),
        (dict(pool_size=64, loss_p=0.02, time_limit_ns=200_000_000), 100, False),
        (dict(pool_size=40, loss_p=1.0), 50, False),
        (dict(pool_size=256, loss_p=0.3), 150, True),
    ],
    ids=["entry_1", "entry_60", "bench_while", "time_limit", "certain_loss", "lossy_256"],
)
def test_host_built_kernel_matches_plain_step(host_lib, kw, n_steps, until_halted):
    wl, cfg = make_raft(), tcore.EngineConfig(**kw)
    st = tcore.make_init(wl, cfg, device="cpu")(np.arange(64, dtype=np.uint64) * np.uint64(7919))
    run = tcore.make_run_while_plain if until_halted else tcore.make_run_plain
    want = state_to_numpy(run(wl, cfg, n_steps)(st))
    got = state_to_numpy(host_run(host_lib, wl, cfg, st, n_steps, until_halted))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_host_built_kernel_halt_counts(host_lib):
    """The stop-at-halt pass reports, per seed, the steps a plain loop
    needs until that seed halts."""
    factory, kw, _n, cap = BENCH_SPECS["raft"]
    wl, cfg = factory(), tcore.EngineConfig(**kw)
    st = tcore.make_init(wl, cfg, device="cpu")(np.arange(16, dtype=np.uint64))
    out = tcore.SimState(**{f: getattr(st, f).clone() for f in tcore.STATE_FIELDS})
    iters = host_launch(host_lib, wl, cfg, out, torch.full((16,), cap, dtype=torch.int64), True)
    step = tcore.make_step_plain(wl, cfg)
    halted_at = np.full(16, -1)
    for i in range(int(iters.max())):
        st = step(st)
        newly = st.halted.numpy() & (halted_at < 0)
        halted_at[newly] = i + 1
    np.testing.assert_array_equal(iters.numpy(), halted_at)


def test_registry_shapes_equal_the_factories():
    """Each registered model's compiled shape and variant is what the
    port's factory builds at its defaults, and its runtime words name
    factory parameters."""
    specs = {**BENCH_SPECS, **SOAK_SPECS}
    made = [f() for f, *_ in specs.values()] + [make_kvchaos(payload=True)]
    assert sorted(w.name for w in made) == sorted(fused.MODELS)
    for wl in made:
        spec = fused.kernel_model(wl)
        assert spec.shape == fused.workload_shape(wl)
        assert spec.pools and all(p >= wl.n_nodes for p in spec.pools)
        params = dict(wl.model_params)
        assert set(spec.words) <= set(params) and all(
            params[k] == v for k, v in spec.fixed
        )
        words = fused.config_words(wl, tcore.EngineConfig())
        assert len(words) == 8 + len(spec.words)
    bench_pools = {f().name: kw["pool_size"] for f, kw, _n, _c in specs.values()}
    for name, pool in bench_pools.items():
        assert pool in fused.MODELS[name].pools, name


def test_every_trait_dispatches_its_handlers_in_order():
    """Each model header's ``handle`` that switches on the handler
    names handlers 0..H-2 by ``case`` and leaves ``default`` to the last
    one. nvcc (12.8) lowered a switch whose ``default`` stood for a
    handler between two cases wrongly on the card (csrc/model_twophase.cuh
    says how), which no g++ build shows."""
    for spec in fused.MODELS.values():
        body = (fused.CSRC / spec.header).read_text()
        body = body[body.index("void handle("):]
        if "switch (h)" not in body:
            continue  # microbench: if (h == 0) ... else ...
        labels = [int(x) for x in re.findall(r"\bcase (\d+):", body)]
        h = spec.shape[5]
        assert sorted(labels) == list(range(h - 1)), spec.key
        assert body.count("default:") == 1, spec.key


# ---------------------------------------------------------------------------
# the real kernel, on the card
# ---------------------------------------------------------------------------

CARD_CASES = {
    # name -> (factory, engine kwargs, seeds, cap)
    **{
        k: (f, kw, min(n, 4096), cap)
        for k, (f, kw, n, cap) in {**BENCH_SPECS, **SOAK_SPECS}.items()
    },
    "kvchaos-payload": (
        lambda: make_kvchaos(payload=True), BENCH_SPECS["kvchaos"][1], 4096,
        BENCH_SPECS["kvchaos"][3],
    ),
}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card with -m cuda)")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_step_on_card():
    _needs_card()
    factory, kw, _n, cap = BENCH_SPECS["raft"]
    wl, cfg = factory(), tcore.EngineConfig(**kw)
    st = tcore.make_init(wl, cfg, device="cuda")(np.arange(4096, dtype=np.uint64))
    before = fused.KERNEL.counts.get("raft", 0)
    got = tcore.make_run_while(wl, cfg, cap)(st)
    assert fused.KERNEL.counts["raft"] == before + 2
    want = tcore.make_run_while_plain(wl, cfg, cap)(st)
    a, b = state_to_numpy(got), state_to_numpy(want)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    with pytest.raises(NotImplementedError):
        bad = tcore.Workload(name="other", n_nodes=5, state_width=6,
                             handlers=wl.handlers, max_emits=6, args_words=2)
        tcore.make_run(bad, cfg, 3)(st)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_cuda_kernel_matches_plain_step_per_model(name):
    """Every registered model's kernel equals the plain step on the card,
    for make_run_while at the bench config and a fixed-step run cut
    mid-way, before the first seed halts."""
    _needs_card()
    factory, kw, n, cap = CARD_CASES[name]
    wl, cfg = factory(), tcore.EngineConfig(**kw)
    st = tcore.make_init(wl, cfg, device="cuda")(np.arange(n, dtype=np.uint64))
    before = fused.KERNEL.counts.get(fused.kernel_model(wl).key, 0)
    got = state_to_numpy(tcore.make_run_while(wl, cfg, cap)(st))
    assert fused.KERNEL.counts[fused.kernel_model(wl).key] == before + 2
    want = state_to_numpy(tcore.make_run_while_plain(wl, cfg, cap)(st))
    for field in got:
        np.testing.assert_array_equal(got[field], want[field], err_msg=field)
    assert got["halted"].all() and got["overflow"].sum() == 0
    first_halt = int(fused.halt_counts(wl, cfg, cap, st).min())
    mid = max(1, min(int(got["step"][0]) // 3, first_halt - 1))
    got = state_to_numpy(tcore.make_run(wl, cfg, mid)(st))
    want = state_to_numpy(tcore.make_run_plain(wl, cfg, mid)(st))
    for field in got:
        np.testing.assert_array_equal(got[field], want[field], err_msg=field)
    assert got["ev_valid"].any(axis=1).all()


@pytest.fixture(scope="module")
def chaos3_model(tmp_path_factory):
    return chaos3_spec(tmp_path_factory.mktemp("chaos3"))


@pytest.mark.cuda
@pytest.mark.parametrize("until_halted", [False, True], ids=["fixed", "while"])
def test_cuda_engine_kinds_match_plain_step(chaos3_model, monkeypatch, until_halted):
    """The engine kinds no ported model emits on the card (pause and
    resume, node clogs, the clog-backoff reschedule with its retries
    byte) run through the real kernel: the chaos3 model trait, built by
    nvcc from the registry's own translation unit, equals the plain step
    per field."""
    _needs_card()
    monkeypatch.setitem(fused.MODELS, chaos3_model.name, chaos3_model)
    wl, cfg = chaos3_workload(), tcore.EngineConfig(**CHAOS_CFG)
    seeds = np.arange(1024, dtype=np.uint64) * np.uint64(0x9E3779B1)
    st = tcore.make_init(wl, cfg, device="cuda")(seeds)
    if until_halted:
        run, plain = tcore.make_run_while, tcore.make_run_while_plain
    else:
        run, plain = tcore.make_run, tcore.make_run_plain
    before = fused.KERNEL.counts.get(chaos3_model.key, 0)
    got = state_to_numpy(run(wl, cfg, 150)(st))
    assert fused.KERNEL.counts[chaos3_model.key] == before + (2 if until_halted else 1)
    want = state_to_numpy(plain(wl, cfg, 150)(st))
    for field in want:
        np.testing.assert_array_equal(got[field], want[field], err_msg=field)
    assert want["paused"].any() and want["clog"].any() and (~want["alive"]).any()
    assert (want["ev_meta"] >> 24).max() > 0  # clog/pause reschedules


@pytest.mark.cuda
def test_cuda_build_refuses_a_host_only_handler(chaos3_model, tmp_path):
    """A model header whose handler lacks MADSIM_HD is a host function
    the device step cannot call; nvcc would only warn and the kernel
    would run without its handlers, so the build fails instead."""
    _needs_card()
    header = tmp_path / "model_hostonly.cuh"
    header.write_text(CHAOS3_MODEL.replace("static MADSIM_HD void handle", "static void handle"))
    spec = dataclasses.replace(chaos3_model, key="hostonly", header=str(header))
    with pytest.raises(RuntimeError, match=r"(?s)nvcc failed.*is not allowed"):
        fused.build_library(spec)
