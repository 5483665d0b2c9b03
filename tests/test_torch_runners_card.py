"""The engine runners on the card: one test per path, each marked
``cuda`` and skipped without a card. On a CUDA state every path
launches the run kernel, as the launch counts show, and equals the
plain step's result. The file imports no JAX, so it runs on the card:
``python -m pytest -m cuda --noconftest tests/test_torch_runners_card.py``.
"""

import numpy as np
import pytest
import torch

from madsim_tpu_torch.check import BatchHistory, check_kv
from madsim_tpu_torch.check import device as dc
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.checkpoint import load, save
from madsim_tpu_torch.engine.compact import RESULT_FIELDS, make_run_compacted, make_run_compacted_plain
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.engine.measure import measure_latency, measure_throughput
from madsim_tpu_torch.engine.replay import refold, replay
from madsim_tpu_torch.engine.search import search_seeds
from madsim_tpu_torch.engine.verify import check_determinism, check_layouts
from madsim_tpu_torch.models import BENCH_SPECS, make_kvchaos, make_pingpong, make_raft

RAFT_KW, RAFT_CAP = BENCH_SPECS["raft"][1], BENCH_SPECS["raft"][3]
KV_KW = BENCH_SPECS["kvchaos"][1]
KV_SCREENS = (dc.stale_reads(), dc.read_your_writes())


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card with -m cuda)")


def _counts(key, fn):
    """``fn()``, and the (run kernel, drain kernel) launches of model
    ``key`` it made."""
    c = fused.KERNEL.counts
    before = c.get(key, 0), c.get(f"{key}/drain", 0)
    out = fn()
    torch.cuda.synchronize()
    return out, (c.get(key, 0) - before[0], c.get(f"{key}/drain", 0) - before[1])


def too_strong(v):
    return (np.asarray(v["node_state"])[:, 1:5, 1] >= 5).all(axis=1)


@pytest.mark.cuda
def test_cuda_compacted_run_is_one_launch_equal_to_the_phase_program():
    _needs_card()
    wl, cfg = make_raft(), tcore.EngineConfig(**RAFT_KW)
    st = tcore.make_init(wl, cfg, device="cuda")(np.arange(4096, dtype=np.uint64))
    run = make_run_compacted(wl, cfg, RAFT_CAP, min_size=256)
    got, launches = _counts("raft", lambda: run(st))
    assert launches == (1, 0)
    want = make_run_compacted_plain(wl, cfg, RAFT_CAP, min_size=256)(st)
    lock = state_to_numpy(tcore.make_run_while(wl, cfg, RAFT_CAP)(st))
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        if f != "step":
            np.testing.assert_array_equal(getattr(got, f), lock[f], err_msg=f)


@pytest.mark.cuda
def test_cuda_search_matches_the_cpu_and_compact():
    _needs_card()
    wl, cfg = make_kvchaos(writes=5), tcore.EngineConfig(**KV_KW)
    full, launches = _counts("kvchaos", lambda: search_seeds(
        wl, cfg, too_strong, n_seeds=1024, max_steps=900, device="cuda"))
    assert launches == (1, 1)
    fast, launches = _counts("kvchaos", lambda: search_seeds(
        wl, cfg, too_strong, n_seeds=1024, max_steps=900, compact=True, device="cuda"))
    assert launches == (1, 0)
    cpu = search_seeds(wl, cfg, too_strong, n_seeds=256, max_steps=900, device="cpu")
    assert 0 < full.failing_seeds.size < 1024
    np.testing.assert_array_equal(full.failing_seeds, fast.failing_seeds)
    np.testing.assert_array_equal(full.traces, fast.traces)
    np.testing.assert_array_equal(full.traces[:256], cpu.traces)
    np.testing.assert_array_equal(full.ok[:256], cpu.ok)


@pytest.mark.cuda
def test_cuda_measurement_runs_the_kernel():
    _needs_card()
    wl, cfg = make_raft(), tcore.EngineConfig(**RAFT_KW)
    rec, launches = _counts("raft", lambda: measure_throughput(
        wl, cfg, RAFT_CAP, 4096, target_wall_s=0.2, n_measure=2, seed_mod=524288,
        min_size=1024, device="cuda"))
    assert launches[0] >= 2 + 2 * rec["repeats"] and launches[1] == 0
    assert rec["overflow"] == 0 and rec["all_halted"] and len(rec["device_walls_s"]) == 2
    lat = measure_latency(make_pingpong(rounds=5), tcore.EngineConfig(pool_size=32), 300,
                          target_wall_s=0.2, n_measure=2, device="cuda")
    assert lat["overflow"] == 0 and lat["all_halted"] and lat["wall_us_per_sim_median"] > 0


@pytest.mark.cuda
def test_cuda_determinism_checks():
    _needs_card()
    wl, cfg = make_raft(), tcore.EngineConfig(**RAFT_KW)
    seeds = np.arange(4096, dtype=np.uint64)
    _out, launches = _counts("raft", lambda: check_determinism(wl, cfg, seeds, 60, device="cuda"))
    assert launches == (2, 0)
    _out, launches = _counts("raft", lambda: check_layouts(wl, cfg, seeds, 60, device="cuda"))
    assert launches == (1, 0)


@pytest.mark.cuda
def test_cuda_checkpoint_resumes_identically(tmp_path):
    _needs_card()
    wl, cfg = make_raft(), tcore.EngineConfig(**RAFT_KW)
    st = tcore.make_init(wl, cfg, device="cuda")(np.arange(4096, dtype=np.uint64))
    path = str(tmp_path / "ck.npz")
    save(path, tcore.make_run(wl, cfg, 20)(st), cfg)
    resumed = tcore.make_run(wl, cfg, 80)(load(path, cfg, device="cuda"))
    whole = tcore.make_run(wl, cfg, 100)(st)
    for f in tcore.STATE_FIELDS:
        assert torch.equal(getattr(resumed, f), getattr(whole, f)), f


@pytest.mark.cuda
def test_cuda_failing_seed_replays_to_the_kernel_trace():
    _needs_card()
    wl, cfg = make_kvchaos(writes=5), tcore.EngineConfig(**KV_KW)
    report = search_seeds(wl, cfg, too_strong, n_seeds=1024, max_steps=900, device="cuda")
    seed = int(report.failing_seeds[0])
    events, res = replay(wl, cfg, seed, 900)
    want = int(report.traces[list(report.seeds).index(seed)])
    assert refold(events, wl) == res.trace == want


@pytest.mark.cuda
def test_cuda_screens_equal_the_cpu_on_record_columns():
    """The history screens and the fold on a record library's columns on
    the card equal the same ops on their CPU copy and the numpy
    detectors."""
    _needs_card()
    wl, cfg = make_kvchaos(writes=5, record=True, bug=True), tcore.EngineConfig(**KV_KW)
    out = tcore.make_run_while(wl, cfg, 900)(
        tcore.make_init(wl, cfg, device="cuda")(np.arange(4096, dtype=np.uint64)))
    cols = [out.hist_word, out.hist_t, out.hist_count, out.hist_drop]
    ok = dc.screen_ok(KV_SCREENS, *cols)
    assert ok.device.type == "cuda"
    cpu = [c.cpu() for c in cols]
    assert torch.equal(ok.cpu(), dc.screen_ok(KV_SCREENS, *cpu))
    host = dc.screens_invariant(KV_SCREENS)(BatchHistory(*(c.numpy() for c in cpu)))
    np.testing.assert_array_equal(ok.cpu().numpy(), host)
    assert 0 < int((~ok).sum()) < 4096
    np.testing.assert_array_equal(dc.unpack_verdicts(dc.pack_verdicts(ok), 4096), host)
    for got, want in zip(dc.fold_verified(*cols, ok), dc.fold_verified(*cpu, ok.cpu())):
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_device_check_equals_history_invariant():
    """search_seeds(device_check=...) on the card, lockstep and
    compacted, flags the seeds that the host detectors flag."""
    _needs_card()
    wl, cfg = make_kvchaos(writes=5, record=True, bug=True), tcore.EngineConfig(pool_size=192, loss_p=0.05)
    kw = dict(n_seeds=1024, max_steps=1500, device="cuda")
    key = fused.kernel_model(wl).key
    host = search_seeds(wl, cfg, None, history_invariant=dc.screens_invariant(KV_SCREENS), **kw)
    lock, launches = _counts(key, lambda: search_seeds(wl, cfg, None, device_check=KV_SCREENS, **kw))
    assert launches == (1, 1)
    fast, launches = _counts(key, lambda: search_seeds(
        wl, cfg, None, device_check=KV_SCREENS, compact=True, **kw))
    assert launches == (1, 0)
    assert 0 < host.failing_seeds.size < 1024
    for rep in (lock, fast):
        np.testing.assert_array_equal(rep.ok, host.ok)
        np.testing.assert_array_equal(rep.flagged_idx, np.nonzero(~host.ok)[0])
        np.testing.assert_array_equal(rep.verdict_words, lock.verdict_words)
        for i in range(len(rep.flagged_history)):
            assert not check_kv(rep.flagged_history.ops(i)).ok
    assert fast.hist_fold.sum() > 0


@pytest.mark.cuda
def test_cuda_plan_search_matches_the_cpu():
    """A fault plan's search on the card: the kvchaos lost-write mutant
    without its own chaos, under the nemesis soak's crash storm, flags
    the plain step's seeds on the CPU with its traces and plan hash,
    compact off and on; the first failing seed's shrink replays."""
    from madsim_tpu_torch.chaos import CrashStorm, FaultPlan, shrink_plan

    _needs_card()
    plan = FaultPlan((CrashStorm(
        targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
        down_min_ns=50_000_000, down_max_ns=250_000_000),), name="kv-nemesis")
    wl = make_kvchaos(writes=5, record=True, bug=True, chaos=False)
    cfg, key = tcore.EngineConfig(pool_size=192, loss_p=0.05), "kvchaos-bug-nochaos"
    assert fused.kernel_model(wl).key == key

    def lost_write(h):
        from madsim_tpu_torch.check import read_your_writes, stale_reads
        return stale_reads(h) & read_your_writes(h)

    full, launches = _counts(key, lambda: search_seeds(
        wl, cfg, None, n_seeds=1024, max_steps=1500, history_invariant=lost_write,
        plan=plan, device="cuda"))
    assert launches == (1, 1)
    fast, launches = _counts(key, lambda: search_seeds(
        wl, cfg, None, n_seeds=1024, max_steps=1500, history_invariant=lost_write,
        plan=plan, compact=True, device="cuda"))
    assert launches == (1, 0)
    cpu = search_seeds(wl, cfg, None, n_seeds=64, max_steps=1500,
                       history_invariant=lost_write, plan=plan, device="cpu")
    assert 0 < full.failing_seeds.size < 1024 and full.plan_hash == plan.hash()
    np.testing.assert_array_equal(full.failing_seeds, fast.failing_seeds)
    np.testing.assert_array_equal(full.traces, fast.traces)
    np.testing.assert_array_equal(full.traces[:64], cpu.traces)
    np.testing.assert_array_equal(full.ok[:64], cpu.ok)
    bad = int(full.failing_seeds[0])
    res = shrink_plan(wl, cfg, bad, plan, history_invariant=lost_write, max_steps=1500,
                      device="cuda")
    rep = search_seeds(wl, cfg, None, n_seeds=1, max_steps=1500, seed_base=bad,
                       history_invariant=lost_write, plan=res.plan, device="cuda")
    assert rep.failing_seeds.tolist() == [bad] and int(rep.traces[0]) == res.trace


@pytest.mark.cuda
def test_cuda_store_search_and_shrink_match_the_cpu():
    """A storage search on the card: the raftlog nosync mutant under a
    three-kill crash storm, with metrics, flags the plain step's seeds on
    the CPU with its traces and counters; the first failing seed's shrink
    equals the CPU's and replays."""
    from madsim_tpu_torch.chaos import CrashStorm, FaultPlan, shrink_plan
    from madsim_tpu_torch.check import election_safety, recovery_safety
    from madsim_tpu_torch.models import make_raftlog
    from madsim_tpu_torch.models.raftlog import OP_COMMIT, OP_ELECT, OP_RECOVER, OP_SYNCED

    _needs_card()
    plan = FaultPlan((CrashStorm(
        targets=(0, 1, 2, 3, 4), n=3, t_min_ns=150_000_000, t_max_ns=400_000_000,
        down_min_ns=50_000_000, down_max_ns=200_000_000),), name="crash3")
    wl = make_raftlog(record=True, chaos=False, durable=True, bug="nosync")
    cfg = tcore.EngineConfig(pool_size=128, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
    key = "raftlog-nosync-record"
    assert fused.kernel_model(wl).key == key

    def store(h):
        return (election_safety(h, elect_op=OP_COMMIT) & election_safety(h, elect_op=OP_ELECT)
                & recovery_safety(h, sync_op=OP_SYNCED, recover_op=OP_RECOVER))

    kw = dict(max_steps=6000, history_invariant=store, plan=plan, require_halt=False,
              metrics=True)
    card, launches = _counts(key, lambda: search_seeds(wl, cfg, None, n_seeds=512,
                                                       device="cuda", **kw))
    assert launches == (1, 1)
    cpu = search_seeds(wl, cfg, None, n_seeds=64, device="cpu", **kw)
    assert 37 in card.failing_seeds.tolist()
    np.testing.assert_array_equal(card.traces[:64], cpu.traces)
    np.testing.assert_array_equal(card.ok[:64], cpu.ok)
    np.testing.assert_array_equal(card.met[:64], cpu.met)
    res = shrink_plan(wl, cfg, 37, plan, history_invariant=store, max_steps=6000,
                      device="cuda")
    want = shrink_plan(wl, cfg, 37, plan, history_invariant=store, max_steps=6000,
                       device="cpu")
    assert (res.events, res.rounds, res.tested, res.trace) == (
        want.events, want.rounds, want.tested, want.trace)
    rep = search_seeds(wl, cfg, None, seeds=np.asarray([37], np.uint64), device="cuda", **kw)
    assert rep.failing_seeds.tolist() == [37] and int(rep.traces[0]) == res.trace


@pytest.mark.cuda
def test_cuda_taps_through_search_and_compaction_match_the_cpu():
    """Coverage and the timeline ring on the card: a search's bitmaps
    and rings, and the compacted runner's banks, equal the CPU plain
    step's; the ring refolds to the trace."""
    _needs_card()
    from madsim_tpu_torch.obs import decode_timeline, refold_timeline

    wl, cfg = make_raft(), tcore.EngineConfig(**RAFT_KW)
    taps = dict(cov_words=64, cov_hitcount=True, timeline_cap=16)
    kw = dict(n_seeds=512, max_steps=RAFT_CAP, **taps)
    gpu, launches = _counts("raft", lambda: search_seeds(wl, cfg, lambda v: np.ones(512, bool),
                                                         device="cuda", **kw))
    assert launches == (1, 1)
    cpu = search_seeds(wl, cfg, lambda v: np.ones(512, bool), device="cpu", **kw)
    np.testing.assert_array_equal(gpu.cov, cpu.cov)
    for f in tcore.TIMELINE_FIELDS:
        np.testing.assert_array_equal(getattr(gpu.timeline, f), getattr(cpu.timeline, f),
                                      err_msg=f)
    assert gpu.banner() == cpu.banner() and gpu.tl_dropped.any()
    i = int(np.nonzero(~gpu.tl_dropped)[0][0])
    assert refold_timeline(decode_timeline(gpu.timeline, wl, i), wl) == int(gpu.traces[i])
    st = tcore.make_init(wl, cfg, device="cuda", **taps)(np.arange(512, dtype=np.uint64))
    run = make_run_compacted(wl, cfg, RAFT_CAP, min_size=64, **taps)
    got, launches = _counts("raft", lambda: run(st))
    assert launches == (1, 0)
    want = make_run_compacted_plain(wl, cfg, RAFT_CAP, min_size=64, **taps)(st.to("cpu"))
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["kvchaos-army-nochaos", "kvchaos-record-army",
                                 "raftlog-record-army", "leasekv-army",
                                 "shardkv-record-army-nochaos"])
def test_cuda_army_libraries_with_the_latency_tap_match_the_cpu(key):
    """Each client-army library under its client army and a crash storm,
    with the latency tap (and, where the library has them, every
    observability tap): one run and one drain launch, every field equal
    to the plain step on the CPU; with the tap off, every other field
    the same but the bitmap and hit counters, which the latency features
    feed."""
    from madsim_tpu_torch.chaos import CrashStorm, FaultPlan
    from madsim_tpu_torch.models import kvchaos, leasekv, raftlog, shardkv

    _needs_card()
    cases = {
        "kvchaos-army-nochaos": (
            kvchaos.make_kvchaos(n_replicas=2, chaos=False, army=True, army_probes=3), 160,
            kvchaos.client_army(n_ops=32, n_replicas=2), (1, 2)),
        "kvchaos-record-army": (
            kvchaos.make_kvchaos(record=True, army=True, army_probes=2), 72,
            kvchaos.client_army(n_ops=10), (1, 2, 3, 4)),
        "raftlog-record-army": (raftlog.make_raftlog(record=True, army=True), 96,
                                raftlog.client_army(n_ops=10), (0, 1, 2, 3, 4)),
        "leasekv-army": (leasekv.make_leasekv(army=True), 48, leasekv.client_army(n_ops=16),
                         (1, 2, 3)),
        "shardkv-record-army-nochaos": (
            shardkv.make_shardkv(record=True, army=True, chaos=False), 96,
            shardkv.client_army(n_ops=16), (2, 5, 8, 11)),
    }
    wl, pool, army, targets = cases[key]
    assert fused.kernel_model(wl).key == key
    cfg = tcore.EngineConfig(pool_size=pool, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
    plan = FaultPlan((army, CrashStorm(targets=targets, n=1)))
    lat = tcore.LatencySpec(ops=army.n_ops, phases=2)
    taps = (dict(cov_words=8, cov_hitcount=True, timeline_cap=48)
            if pool in fused.MODELS[key].obs_pools else {})
    seeds = np.arange(512, dtype=np.uint64)
    rows = plan.compile_batch(seeds, wl=wl)
    st = tcore.make_init(wl, cfg, device="cpu", plan_slots=plan.slots, latency=lat,
                         **taps)(seeds, rows)
    got, launches = _counts(key, lambda: tcore.make_run_while(wl, cfg, 4000, latency=lat, **taps)(
        st.to("cuda")))
    assert launches == (1, 1)
    want = state_to_numpy(tcore.make_run_while_plain(wl, cfg, 4000, latency=lat, **taps)(st))
    got = state_to_numpy(got)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert want["lat_count"].sum() > 0 and not want["lat_drop"].any()
    off = state_to_numpy(tcore.make_run_while(wl, cfg, 4000, **taps)(
        tcore.make_init(wl, cfg, device="cuda", plan_slots=plan.slots, **taps)(seeds, rows)))
    fed = ("cov", "cov_hits") if taps else ()
    for f in off:
        if f not in (*tcore.LATENCY_FIELDS, *fed):
            np.testing.assert_array_equal(off[f], want[f], err_msg=f)
    if taps:
        assert (off["cov"] != want["cov"]).any()


@pytest.mark.cuda
def test_cuda_explore_campaigns_match_the_cpu():
    """Exploration on the card: the host campaign (``explore.run``, its
    generations through the run kernel) and the device campaign
    (``explore.run_device``: the mutator, the plan compile and the
    admission as torch ops on the card) over raft at pool 64 with the
    taps kernel equal the same campaigns on the CPU entry for entry,
    with one run and one drain launch a generation."""
    from madsim_tpu_torch import explore
    from madsim_tpu_torch.chaos import FaultPlan, GrayFailure, PauseStorm

    _needs_card()
    nodes = (0, 1, 2, 3, 4)
    plan = FaultPlan((
        PauseStorm(targets=nodes, n=1, t_min_ns=20_000_000, t_max_ns=300_000_000,
                   down_min_ns=50_000_000, down_max_ns=200_000_000),
        GrayFailure(targets=nodes, n_links=1),
    ), name="device-explore-test")
    wl, cfg = make_raft(), tcore.EngineConfig(pool_size=64, loss_p=0.02)
    kw = dict(generations=3, batch=64, root_seed=11, max_steps=600, cov_words=16,
              invariant=lambda v: (v["trace"] & 7) != 0)

    def fp(rep):
        return ([(e.id, e.generation, e.parent, e.seed, e.plan.hash(), e.trace, e.new_bits,
                  e.violating, e.halt_t) for e in rep.corpus], rep.cov_map.tolist(),
                [(e.seed, e.trace) for e in rep.violations], rep.curve, rep.viol_curve)

    want = fp(explore.run(wl, cfg, plan, device="cpu", **kw))
    for campaign in (explore.run, explore.run_device):
        rep, launches = _counts("raft", lambda: campaign(wl, cfg, plan, device="cuda", **kw))
        assert launches == (3, 3)
        assert fp(rep) == want
    assert fp(explore.run_device(wl, cfg, plan, device="cpu", **kw)) == want
