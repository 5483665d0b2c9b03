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
from madsim_tpu_torch.models import (
    BENCH_SPECS, RECORD_VARIANTS, SOAK_SPECS, make_kvchaos, make_raft, make_raftlog,
)

from _torch_chaos3 import CHAOS3_MODEL, CHAOS_CFG, chaos3_family, chaos3_spec, chaos3_workload
from _torch_host import build_host_kernel, host_drain, host_launch, host_run

RAFT_POOLS = (40, 64, 128, 256)
INF = 2**62


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    spec = fused.MODELS["raft"]
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
    _out, iters, tmax = host_launch(host_lib, wl, cfg, st, cap, True)
    assert int(tmax) == int(iters.max())
    step = tcore.make_step_plain(wl, cfg)
    halted_at = np.full(16, -1)
    for i in range(int(iters.max())):
        st = step(st)
        newly = st.halted.numpy() & (halted_at < 0)
        halted_at[newly] = i + 1
    np.testing.assert_array_equal(iters.numpy(), halted_at)


def _halted_pools(pool, kind, seed=3, n=48):
    """A raft state of ``n`` halted seeds whose pools are made up here:
    ``random`` times, ``ties`` (a few distinct times, so many equal),
    ``beyond`` (some slots at exactly 2^62 and some later), ``full``
    (every slot valid, the latest beyond 2^62)."""
    wl, cfg = make_raft(), tcore.EngineConfig(pool_size=pool)
    st = tcore.make_init(wl, cfg, device="cpu")(np.arange(n, dtype=np.uint64))
    rng = np.random.default_rng(seed)
    valid = rng.random((n, pool)) < 0.6
    if kind == "ties":
        time = rng.integers(0, 3, (n, pool)) * 1000
    else:
        time = rng.integers(0, 10**9, (n, pool))
    if kind in ("beyond", "full"):
        pick = rng.random((n, pool))
        time = np.where(pick < 0.2, INF, np.where(pick < 0.4, INF + rng.integers(1, 9, (n, pool)), time))
    if kind == "full":
        valid[:] = True
        valid[: n // 2, 0] = False
    st.ev_valid = torch.from_numpy(valid)
    st.ev_time = torch.from_numpy(time.astype(np.int64))
    st.halted = torch.ones(n, dtype=torch.bool)
    return wl, cfg, st, rng


@pytest.mark.parametrize("pool", [40, 256])
@pytest.mark.parametrize("kind", ["random", "ties", "beyond", "full"])
def test_host_drain_matches_halted_plain_steps(host_lib, pool, kind):
    """The drain primitive, g++-built, equals r plain steps of a halted
    seed: r drawn from 0 to past the number of valid slots, equal times
    (the first index wins), slots at and beyond 2^62 (which the plain
    step's argmin pops after the empty slots tied at 2^62)."""
    wl, cfg, st, rng = _halted_pools(pool, kind)
    n = st.seed.shape[0]
    n_valid = st.ev_valid.sum(1).numpy()
    r = rng.integers(0, pool + 3, n)
    r[::4] = n_valid[::4] + rng.integers(0, 3, n)[::4]  # r at or past the valid count
    r[1::4] = np.maximum(n_valid[1::4] - 1, 0)
    tmax = torch.tensor([int(r.max())], dtype=torch.int64)
    iters = tmax - torch.from_numpy(r)
    out = tcore.SimState(**{f: getattr(st, f).clone() for f in tcore.STATE_FIELDS})
    host_drain(host_lib, out, iters, tmax)
    want_step, want_valid = fused.drain_plain(st.step, st.ev_valid, st.ev_time, tmax - iters)
    np.testing.assert_array_equal(out.step.numpy(), want_step.numpy())
    np.testing.assert_array_equal(out.ev_valid.numpy(), want_valid.numpy())
    # the drain wrapper takes that plain version on a CPU state
    cpu = tcore.SimState(**{f: getattr(st, f).clone() for f in tcore.STATE_FIELDS})
    fused.KERNEL.drain(fused.MODELS["raft"], cpu, iters, tmax)
    assert torch.equal(cpu.step, want_step) and torch.equal(cpu.ev_valid, want_valid)
    # drain_plain is r plain steps of the halted seeds
    step, ref = tcore.make_step_plain(wl, cfg), st
    for k in range(int(r.max())):
        nxt = step(ref)
        keep = torch.from_numpy(k < r)
        ref = tcore.SimState(**{
            f: torch.where(keep.view(-1, *[1] * (getattr(nxt, f).dim() - 1)),
                           getattr(nxt, f), getattr(ref, f))
            for f in tcore.STATE_FIELDS
        })
    np.testing.assert_array_equal(out.ev_valid.numpy(), ref.ev_valid.numpy())
    np.testing.assert_array_equal(out.step.numpy(), ref.step.numpy())


def test_host_step_pops_like_the_plain_step_past_2_62(host_lib):
    """Live seeds whose pools hold slots at and beyond 2^62: the
    g++-built step pops what the plain step's argmin pops."""
    wl, cfg, st, _rng = _halted_pools(40, "beyond", seed=5)
    st.halted = torch.zeros_like(st.halted)
    st.ev_valid[:, :5] = True  # the on_init events stay
    st.ev_time[:, :5] = 0
    # in every other seed no slot is live, and slot 0 lies beyond 2^62:
    # the plain step pops the first empty slot, which holds no event
    late = torch.arange(st.seed.shape[0]) % 2 == 1
    st.ev_valid[late] &= st.ev_time[late] >= INF
    st.ev_valid[late, 0] = True
    st.ev_time[late, 0] = INF + 1
    want = state_to_numpy(tcore.make_run_plain(wl, cfg, 40)(st))
    got = state_to_numpy(host_run(host_lib, wl, cfg, st, 40, False))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("group", [4, 8, 32])
@pytest.mark.parametrize("name", ["raft-election", "kvchaos-payload"])
def test_host_lane_groups_match_plain_step(tmp_path_factory, name, group):
    """The serial form of the lane-group primitives at G = 4, 8 and 32:
    the pop's butterfly, the emit rows' ballot and placement, the
    drain's ranks, held against the plain step."""
    wl = make_raft() if name == "raft-election" else make_kvchaos(payload=True)
    spec = fused.kernel_model(wl)
    kw = BENCH_SPECS["raft" if name == "raft-election" else "kvchaos"][1]
    lib = build_host_kernel(tmp_path_factory.mktemp(f"g{group}"), spec, (kw["pool_size"],), group)
    cfg = tcore.EngineConfig(**kw)
    st = tcore.make_init(wl, cfg, device="cpu")(np.arange(24, dtype=np.uint64) * np.uint64(31))
    for n_steps, until_halted in ((40, False), (900, True)):
        run = tcore.make_run_while_plain if until_halted else tcore.make_run_plain
        want = state_to_numpy(run(wl, cfg, n_steps)(st))
        got = state_to_numpy(host_run(lib, wl, cfg, st, n_steps, until_halted))
        for field in want:
            np.testing.assert_array_equal(got[field], want[field], err_msg=field)


def test_registry_shapes_equal_the_factories():
    """Each registered model's compiled shape and variant is what the
    port's factory builds at its defaults, and its runtime words name
    factory parameters."""
    specs = {**BENCH_SPECS, **SOAK_SPECS}
    made = [f() for f, *_ in specs.values()] + [make_kvchaos(payload=True)]
    made += [specs[n][0](**kw) for n, kw in RECORD_VARIANTS.values()]
    assert len({w.name for w in made}) == len(made)
    # raftlog's storage libraries: their variants share their names with
    # its default and record variants, but for the nosync mutant's
    store = dict(record=True, chaos=False, durable=True)
    storage = {
        "raftlog-durable": make_raftlog(durable=True),
        "raftlog-durable-record": make_raftlog(**store),
        "raftlog-nosync-record": make_raftlog(**store, bug="nosync"),
    }
    assert all(fused.kernel_model(w).key == key for key, w in storage.items())
    made += storage.values()
    # the client-army libraries, each at the shape its first run needs
    army = {
        "kvchaos-army-nochaos": make_kvchaos(n_replicas=2, chaos=False, army=True,
                                             army_probes=3),
        "kvchaos-record-army": make_kvchaos(record=True, army=True, army_probes=2),
        "raftlog-record-army": make_raftlog(record=True, army=True),
        "leasekv-army": SOAK_SPECS["leasekv"][0](army=True),
        "shardkv-record-army-nochaos": SOAK_SPECS["shardkv"][0](record=True, army=True,
                                                                chaos=False),
        # the retry soak's (tools/retry_soak.py)
        "kvchaos-record-army-r2-nochaos": make_kvchaos(writes=12, n_replicas=2, chaos=False,
                                                       army=True, record=True),
        "shardkv-noidem-army-nochaos": SOAK_SPECS["shardkv"][0](record=True, army=True,
                                                                chaos=False, bug="noidem"),
    }
    assert all(fused.kernel_model(w).key == key and fused.MODELS[key].lat == w.lat_markers == 1
               for key, w in army.items())
    made += army.values()
    # the etcd lease convergence's library: chaos-free leasekv-record
    # whose client 1 stalls its keepalives (ka_stop_ms, a runtime word)
    stalled = SOAK_SPECS["leasekv"][0](chaos=False, record=True, ka_stop_ms=2000)
    assert fused.kernel_model(stalled).key == "leasekv-record-nochaos"
    made.append(stalled)
    assert sorted({w.name for w in made}) == sorted(
        {m.name for m in fused.MODELS.values()})
    for wl in made:
        spec = fused.kernel_model(wl)
        assert spec.shape == fused.workload_shape(wl)
        assert spec.pools and all(p >= wl.n_nodes for p in spec.pools)
        params = dict(wl.model_params)
        assert set(spec.words) <= set(params) and all(
            params[k] == v for k, v in spec.fixed
        )
        words = fused.config_words(wl, tcore.EngineConfig())
        assert len(words) == 9 + len(spec.words)
        assert words[8] == (wl.history.capacity if wl.history else 0)
    for f, kw, _n, _c in specs.values():
        assert kw["pool_size"] in fused.kernel_model(f()).pools, f().name


def test_every_trait_dispatches_its_handlers_in_order():
    """Each model header's ``handle`` that switches on the handler
    names handlers 0..H-2 by ``case`` and leaves ``default`` to the last
    one (an army library's three client-army handlers come after them and
    are dispatched before the switch). nvcc (12.8) lowered a switch whose
    ``default`` stood for a handler between two cases wrongly on the card
    (csrc/model_twophase.cuh says how), which no g++ build shows."""
    for spec in fused.MODELS.values():
        body = (fused.CSRC / spec.header).read_text()
        body = body[body.index("void handle("):]
        if "switch (h)" not in body:
            continue  # microbench: if (h == 0) ... else ...
        labels = [int(x) for x in re.findall(r"\bcase (\d+):", body)]
        h = spec.shape[5] - (3 if spec.lat else 0)
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
    # the record and bug variants at their family's shape
    **{
        k: ((lambda f=f, x=x: f(**x)), kw, min(n, 4096), cap)
        for k, (name, x) in RECORD_VARIANTS.items()
        for f, kw, n, cap in [{**BENCH_SPECS, **SOAK_SPECS}[name]]
    },
}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card with -m cuda)")


def _launches(key):
    """(run kernel, drain kernel) launches of model ``key`` so far."""
    c = fused.KERNEL.counts
    return c.get(key, 0), c.get(f"{key}/drain", 0)


def _assert_card_equals_plain(wl, cfg, st, n_steps, until_halted):
    """The kernel's run of CPU state ``st`` on the card equals the plain
    step's on the CPU, per field; returns the plain run as numpy."""
    run = tcore.make_run_while if until_halted else tcore.make_run
    plain = tcore.make_run_while_plain if until_halted else tcore.make_run_plain
    got = state_to_numpy(run(wl, cfg, n_steps)(st.to("cuda")))
    want = state_to_numpy(plain(wl, cfg, n_steps)(st))
    for field in want:
        np.testing.assert_array_equal(got[field], want[field], err_msg=field)
    return want


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_step_on_card():
    _needs_card()
    factory, kw, _n, cap = BENCH_SPECS["raft"]
    wl, cfg = factory(), tcore.EngineConfig(**kw)
    st = tcore.make_init(wl, cfg, device="cuda")(np.arange(4096, dtype=np.uint64))
    before = _launches("raft")
    got = tcore.make_run_while(wl, cfg, cap)(st)
    assert _launches("raft") == (before[0] + 1, before[1] + 1)
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
    key = fused.kernel_model(wl).key
    before = _launches(key)
    got = state_to_numpy(tcore.make_run_while(wl, cfg, cap)(st))
    assert _launches(key) == (before[0] + 1, before[1] + 1)
    want = state_to_numpy(tcore.make_run_while_plain(wl, cfg, cap)(st))
    for field in got:
        np.testing.assert_array_equal(got[field], want[field], err_msg=field)
    assert got["halted"].all() and got["overflow"].sum() == 0
    if wl.history is not None:
        assert got["hist_count"].max() > 0 and got["hist_drop"].sum() == 0
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


@pytest.fixture(scope="module")
def chaos3_entry(tmp_path_factory):
    """chaos3 as a ``fused.FAMILIES`` entry, one header for the module:
    a library key names one unit, header path included."""
    return chaos3_family(tmp_path_factory.mktemp("chaos3-family"))


@pytest.mark.cuda
@pytest.mark.parametrize("until_halted", [False, True], ids=["fixed", "while"])
def test_cuda_engine_kinds_match_plain_step(chaos3_entry, monkeypatch, until_halted):
    """The engine kinds no ported model emits on the card (pause and
    resume, node clogs, the clog-backoff reschedule with its retries
    byte) run through the real kernel: the chaos3 model trait, a family
    of its own here, derived and built by nvcc at the state's pool on
    first use, equals the plain step per field."""
    _needs_card()
    monkeypatch.setitem(fused.FAMILIES, "chaos3", chaos3_entry)
    wl, cfg = chaos3_workload(), tcore.EngineConfig(**CHAOS_CFG)
    key = fused.library_for(wl, cfg.pool_size).key
    assert key == f"chaos3-p{cfg.pool_size}"
    seeds = np.arange(1024, dtype=np.uint64) * np.uint64(0x9E3779B1)
    st = tcore.make_init(wl, cfg, device="cuda")(seeds)
    if until_halted:
        run, plain = tcore.make_run_while, tcore.make_run_while_plain
    else:
        run, plain = tcore.make_run, tcore.make_run_plain
    before = _launches(key)
    got = state_to_numpy(run(wl, cfg, 150)(st))
    assert _launches(key) == (before[0] + 1, before[1] + int(until_halted))
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


# ---------------------------------------------------------------------------
# adversarial shapes for the shared-memory, lane-group kernel, on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_equal_times_across_lane_boundaries():
    """Pools whose valid slots share one time at indices that fall to
    different lanes of every group size: the first index must win the
    shuffle reduction, in the step and in the drain."""
    _needs_card()
    wl, cfg = make_raft(), tcore.EngineConfig(pool_size=64, loss_p=0.02)
    st = tcore.make_run_plain(wl, cfg, 12)(
        tcore.make_init(wl, cfg, device="cpu")(np.arange(256, dtype=np.uint64)))
    t = st.ev_time.clone()
    for slots in ((1, 9, 33), (7, 8, 40, 63), (31, 32)):
        col = list(slots)
        t[:, col] = t[:, col].min(1, keepdim=True).values
    st.ev_time = t
    _assert_card_equals_plain(wl, cfg, st, 30, False)
    _assert_card_equals_plain(wl, cfg, st, 600, True)


@pytest.mark.cuda
def test_cuda_full_pool_overflows_like_plain_step():
    """A pool filled with far-future events: the emits find no free
    slot and each one counts as overflow, as in the plain step."""
    _needs_card()
    wl, cfg = make_raft(), tcore.EngineConfig(pool_size=40, loss_p=0.02)
    st = tcore.make_init(wl, cfg, device="cpu")(np.arange(300, dtype=np.uint64))
    st.ev_valid[:, 8:] = True
    st.ev_time[:, 8:] = 10**15 + torch.arange(32)
    want = _assert_card_equals_plain(wl, cfg, st, 40, False)
    assert want["overflow"].sum() > 0


@pytest.mark.cuda
def test_cuda_raft_pool_256():
    """Raft at E = 256, the largest shared layout of the registry."""
    _needs_card()
    _f, kw, _n, cap = BENCH_SPECS["raft"]
    wl, cfg = make_raft(), tcore.EngineConfig(**{**kw, "pool_size": 256})
    st = tcore.make_init(wl, cfg, device="cpu")(np.arange(1024, dtype=np.uint64))
    _assert_card_equals_plain(wl, cfg, st, cap, True)


@pytest.mark.cuda
@pytest.mark.parametrize("n_seeds", [1, 33, 1000])
def test_cuda_ragged_last_block(n_seeds):
    """Seed counts that leave the last block part-filled."""
    _needs_card()
    _f, kw, _n, cap = BENCH_SPECS["raft"]
    wl, cfg = make_raft(), tcore.EngineConfig(**kw)
    st = tcore.make_init(wl, cfg, device="cpu")(np.arange(n_seeds, dtype=np.uint64) + 5)
    _assert_card_equals_plain(wl, cfg, st, cap, True)
    _assert_card_equals_plain(wl, cfg, st, 17, False)


@pytest.mark.cuda
def test_cuda_budget_zero_copies_the_state():
    """A zero-step run launches the kernel and returns the input state,
    in fresh tensors but for the fields the kernel never writes."""
    _needs_card()
    wl, cfg = make_raft(), tcore.EngineConfig(pool_size=40)
    st = tcore.make_init(wl, cfg, device="cuda")(np.arange(100, dtype=np.uint64))
    before = _launches("raft")
    out = tcore.make_run(wl, cfg, 0)(st)
    assert _launches("raft") == (before[0] + 1, before[1])
    for f in tcore.STATE_FIELDS:
        assert torch.equal(getattr(out, f), getattr(st, f)), f
        if getattr(st, f).numel():
            # raft records nothing: its history columns are the input's,
            # and so are the ring's (its two counters too) without a ring
            # and the latency tap's (its two counters too) without the tap
            shared = (f in fused.SHARED_FIELDS or f in fused.HISTORY_COLUMNS
                      or f in fused.RING_FIELDS or f in tcore.LATENCY_FIELDS)
            assert (getattr(out, f).data_ptr() == getattr(st, f).data_ptr()) == shared, f
