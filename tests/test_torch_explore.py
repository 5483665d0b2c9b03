"""The port's exploration host path (``madsim_tpu_torch/explore``)
against the JAX package's ``madsim_tpu.explore``.

The mutator is held draw for draw: ``HostStream`` and ``mutate_plan``
over 256 keys and every retarget mode, and the batched device mutator
of ``explore.device`` against the host edit script child for child.
``admit``, ``popcount`` and ``merge`` equal the JAX package's and
numpy. The host campaign ports ``tests/test_explore.py``'s campaign
cases (raft-record at pool 64, 3 generations of 24, 800 steps,
``cov_words=16``, election safety): the port's corpus, coverage map,
violations and curves equal the JAX package's, across ``compact`` and
``layout``; a corpus entry replays (the kvchaos mutant's campaign is
``test_torch_explore_mutant.py``). A g++ build of the raft library's taps kernel at pool 64 runs a bred
generation's plan rows with ``cov_words=16`` as the plain step does.
Every value is an integer or a hash: equality is exact.
"""

import _torch_threads  # noqa: F401
import dataclasses

import numpy as np
import pytest
import torch
from _torch_explore import NODES, every_mode_plan, fingerprint, raft_plan
from _torch_host import build_host_kernel, host_run

import madsim_tpu.chaos as jch
import madsim_tpu.explore as jx
from madsim_tpu.check import election_safety as j_election
from madsim_tpu.engine import EngineConfig as JCfg
from madsim_tpu.engine.rng import PURPOSE_EXPLORE
from madsim_tpu.engine.rng import np_threefry2x32 as j_threefry
from madsim_tpu.models import make_raft as j_raft
from madsim_tpu.models.raft import OP_ELECT as J_OP_ELECT
import madsim_tpu_torch.chaos as tch
import madsim_tpu_torch.explore as tx
from madsim_tpu_torch.check import election_safety as t_election
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.engine.rng import np_threefry2x32 as t_threefry
from madsim_tpu_torch.explore import device as tdev
from madsim_tpu_torch.explore.mutate import mutation_table
from madsim_tpu_torch import models as tm
from madsim_tpu_torch.models import make_raft as t_raft
from madsim_tpu_torch.models.raft import OP_ELECT as T_OP_ELECT

RAFT_KW = dict(pool_size=64, loss_p=0.02)
KW = dict(generations=3, batch=24, root_seed=11, max_steps=800, cov_words=16)
KEYS = np.random.default_rng(14).integers(0, 2**32, size=(256, 2), dtype=np.uint64)


def _j_inv(h):
    return j_election(h, elect_op=J_OP_ELECT)


def _t_inv(h):
    return t_election(h, elect_op=T_OP_ELECT)


def _events(lp):
    return [dataclasses.astuple(e) for e in lp.events], [bool(x) for x in lp._mask()]


# ---------------------------------------------------------------------------
# mutation
# ---------------------------------------------------------------------------


def test_host_stream_draws_are_the_jax_package():
    for k0, k1 in KEYS:
        a = tx.HostStream(int(k0), int(k1), PURPOSE_EXPLORE)
        b = jx.HostStream(int(k0), int(k1), PURPOSE_EXPLORE)
        assert [a.bits() for _ in range(6)] == [b.bits() for _ in range(6)]
        assert a.uniform(-5, 40) == b.uniform(-5, 40)
        assert a.pick(NODES) == b.pick(NODES)
    rng = np.random.default_rng(3)
    for k0, k1, x0, x1 in rng.integers(0, 2**32, size=(64, 4), dtype=np.uint64):
        assert tuple(map(int, t_threefry(k0, k1, x0, x1))) == tuple(
            map(int, j_threefry(k0, k1, x0, x1)))


def _parents(m):
    """Parents for the mutator: literalized seeds, some with slots
    disabled (so that add fires) and one with every slot off."""
    plan = every_mode_plan(m)
    out = [plan.literalize(s) for s in (3, 4, 5)]
    mask = [i % 3 != 0 for i in range(plan.slots)]
    out.append(m.LiteralPlan(events=out[0].events, enabled=tuple(mask), name="sparse"))
    out.append(m.LiteralPlan(events=out[1].events, enabled=(False,) * plan.slots,
                             name="off"))
    return out


@pytest.mark.parametrize("max_ops", [1, 2, 3])
def test_mutate_plan_children_are_the_jax_package(max_ops):
    tspace, jspace = tx.PlanSpace(every_mode_plan(tch)), jx.PlanSpace(every_mode_plan(jch))
    assert [tx.mutate._effective_mode(t) for t in tspace.templates] == [
        jx.mutate._effective_mode(t) for t in jspace.templates]
    assert set(tx.mutate._effective_mode(t) for t in tspace.templates) == set(range(5))
    tab_t, tab_j = mutation_table(tspace), jx.mutation_table(jspace)
    assert tab_t.keys() == tab_j.keys() and all(
        np.array_equal(tab_t[k], tab_j[k]) for k in tab_t)
    tpar, jpar = _parents(tch), _parents(jch)
    for i, (k0, k1) in enumerate(KEYS):
        p = i % len(tpar)
        horizon = None if i % 2 else 150_000_000
        a = tx.mutate_plan(tpar[p], tspace, tx.HostStream(int(k0), int(k1), PURPOSE_EXPLORE),
                           max_ops=max_ops, name=f"c{i}", horizon=horizon)
        b = jx.mutate_plan(jpar[p], jspace, jx.HostStream(int(k0), int(k1), PURPOSE_EXPLORE),
                           max_ops=max_ops, name=f"c{i}", horizon=horizon)
        assert _events(a) == _events(b), i
        assert a.hash() == b.hash()
    with pytest.raises(ValueError, match="distinct targets"):
        tx.PlanSpace(tch.FaultPlan((tch.GrayFailure(targets=(2, 2), n_links=1),)))


@pytest.mark.parametrize("max_ops", [1, 2, 3])
def test_the_device_mutator_is_the_host_edit_script(max_ops):
    """``explore.device``'s batched mutator breeds, for 256 children at
    once, the parent picks, seeds and plans of the host loop:
    ``HostStream`` draws 0 and 1 and ``mutate_plan`` with the parent's
    halt clock as the horizon."""
    space = tx.PlanSpace(every_mode_plan(tch))
    parents = _parents(tch)
    n, p = len(parents), space.slots
    rows = tch.stack_plan_rows(parents)
    halts = [0, 150_000_000, 60_000_000, 0, 220_000_000]
    seeds = [11, 2**63 + 5, 77, 2**64 - 1, 9]
    viol = [False, True, False, True, False]
    cap1 = 8
    store = tdev._empty_store(cap1, p, 1, torch.device("cpu"))
    for f in tdev._ROW_KEYS:
        store[f][:n] = torch.from_numpy(np.asarray(getattr(rows, f))).to(store[f].dtype)
    store["halt"][:n] = torch.tensor(halts)
    store["seed"][:n] = tdev._u64_as_i64(seeds)
    store["id"][:n] = torch.arange(n) + 40
    # the frontier order of the host loop: violating first, newest first
    order_ids = [e for _v, e in sorted(((not viol[i], -(40 + i)), 40 + i) for i in range(n))]
    order = torch.tensor([i - 40 for i in order_ids] + list(range(n, cap1)))
    thresh = tx.mutate.inherit_threshold(0.5)
    tb = {k: torch.as_tensor(v).to(torch.int64) for k, v in mutation_table(space).items()}
    mut = tdev._make_child_mutator(tb, max_ops, thresh)
    k0s, k1s = (torch.from_numpy(KEYS[:, i].astype(np.int64)) for i in (0, 1))
    fresh = tdev._mk_seeds(k0s, k1s)
    kids = mut(k0s, k1s, fresh, order, torch.tensor(n), store)
    for j, (k0, k1) in enumerate(KEYS):
        st = tx.HostStream(int(k0), int(k1), PURPOSE_EXPLORE)
        pid = order_ids[st.bits() % n]
        seed = seeds[pid - 40] if st.bits() < thresh else int(fresh[j]) % 2**64
        h = halts[pid - 40]
        want = tx.mutate_plan(parents[pid - 40], space, st, max_ops=max_ops,
                              horizon=h if h > 0 else None)
        assert int(kids["parent"][j]) == pid and int(kids["seed"][j]) % 2**64 == seed, j
        got = tch.LiteralPlan(
            events=tuple(tch.FaultEvent(t=int(kids["time"][j, q]), kind=int(kids["kind"][j, q]),
                                        a0=int(kids["args"][j, q, 0]),
                                        a1=int(kids["args"][j, q, 1]),
                                        node=int(kids["node"][j, q])) for q in range(p)),
            enabled=tuple(bool(x) for x in kids["valid"][j]))
        assert _events(got) == _events(want), j


def test_kth_true_takes_the_first_maximum():
    mask = torch.tensor([[False, True, True, False, True], [True, True, True, True, True],
                         [False, False, False, False, False]])
    got = tdev._kth_true(mask, torch.tensor([1, 4, 0])).tolist()
    assert got == [2, 4, 0]


# ---------------------------------------------------------------------------
# coverage accounting
# ---------------------------------------------------------------------------


def test_admit_popcount_and_merge_are_the_jax_package():
    rng = np.random.default_rng(7)
    for b, cw in ((1, 1), (24, 16), (37, 3), (256, 64)):
        batch = (rng.integers(0, 2**32, size=(b, cw), dtype=np.uint64)
                 & rng.integers(0, 2**32, size=(b, cw), dtype=np.uint64)).astype(np.uint32)
        batch[b // 2] = 0xFFFFFFFF  # an all-ones row
        if b > 3:
            batch[3] = batch[1]  # a duplicate of an earlier row
        g = (rng.integers(0, 2**32, size=cw, dtype=np.uint64) & 0x0F0F00FF).astype(np.uint32)
        for gmap in (np.zeros(cw, np.uint32), g):
            nb_t, m_t = tx.admit(batch, gmap)
            nb_j, m_j = jx.admit(batch, gmap)
            assert nb_t.tolist() == np.asarray(nb_j).tolist()
            assert m_t.dtype == np.uint32 and np.array_equal(m_t, np.asarray(m_j))
            # the tensor form on its own device gives the same
            nb_d, m_d = tx.admit(torch.from_numpy(batch.astype(np.int64)),
                                 torch.from_numpy(gmap.astype(np.int64)))
            assert nb_d.tolist() == nb_t.tolist() and np.array_equal(m_d, m_t)
        assert tx.popcount(batch) == jx.popcount(batch) == int(
            np.unpackbits(batch.view(np.uint8)).sum())
        assert np.array_equal(tx.merge(batch), np.bitwise_or.reduce(batch, axis=0))
        assert np.array_equal(tx.merge(batch), jx.merge(batch))
    words = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    got = tx.coverage.popcount32(torch.from_numpy(words.astype(np.int64))).numpy()
    want = np.unpackbits(words.view(np.uint8)).reshape(-1, 32).sum(1)
    assert np.array_equal(got, want)
    assert tx.admit(np.array([[1, 0], [1, 0], [3, 0], [0, 8]], np.uint32),
                    np.zeros(2, np.uint32))[0].tolist() == [1, 0, 1, 1]


# ---------------------------------------------------------------------------
# the host campaign
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_campaign():
    return jx.run(j_raft(record=True), JCfg(**RAFT_KW), raft_plan(jch),
                  history_invariant=_j_inv, **KW)


def _port(**kw):
    args = dict(KW, **kw)
    return tx.run(t_raft(record=True), tcore.EngineConfig(**RAFT_KW), raft_plan(tch),
                  history_invariant=_t_inv, device="cpu", **args)


@pytest.fixture(scope="module")
def port_campaign():
    return _port()


def test_same_root_identical_campaign(jax_campaign, port_campaign):
    assert fingerprint(port_campaign) == fingerprint(jax_campaign)
    assert fingerprint(_port()) == fingerprint(port_campaign)
    assert port_campaign.sims == 3 * 24 and port_campaign.corpus
    assert port_campaign.coverage_bits == jax_campaign.coverage_bits
    assert port_campaign.next_id == jax_campaign.next_id


def test_compact_and_layouts_identical(port_campaign):
    """``compact=True`` equals ``compact=False``; ``layout`` and
    ``pool_index`` change nothing (the port has one lowering)."""
    assert fingerprint(_port(compact=True)) == fingerprint(port_campaign)
    assert fingerprint(_port(layout="dense", pool_index=True)) == fingerprint(port_campaign)


def test_corpus_entry_replays_trace(port_campaign):
    picks = [port_campaign.corpus[0]]
    bred = [e for e in port_campaign.corpus if e.generation > 0]
    assert bred, "the campaign bred nothing"
    picks.append(bred[-1])
    for e in picks:
        r = tx.replay_entry(t_raft(record=True), tcore.EngineConfig(**RAFT_KW), e,
                            history_invariant=_t_inv, max_steps=800, device="cpu")
        assert int(r.traces[0]) == e.trace


def test_different_root_differs(port_campaign):
    assert fingerprint(_port(root_seed=12)) != fingerprint(port_campaign)


def test_energy_waits_for_farm(port_campaign):
    """The farm's power schedule is wired: ``energy=None`` and
    ``EnergySchedule(mode="uniform")`` are the uniform campaign bit for
    bit, an unknown mode raises the JAX package's error."""
    from madsim_tpu_torch.farm import EnergySchedule

    assert fingerprint(_port(energy=None)) == fingerprint(port_campaign)
    assert fingerprint(_port(energy=EnergySchedule(mode="uniform"))) == fingerprint(port_campaign)
    with pytest.raises(ValueError, match="unknown energy mode"):
        _port(energy=EnergySchedule(mode="slow"))


# ---------------------------------------------------------------------------
# the taps kernel on a bred generation (g++ build)
# ---------------------------------------------------------------------------


def test_host_built_raft_taps_kernel_runs_a_bred_generation(tmp_path_factory, port_campaign):
    """raft at pool 64 with the taps (``obs_pools``), a generation bred
    from the campaign's corpus and ``cov_words=16``: the g++ build of
    the kernel's step code equals the plain step in every field, the
    bitmap included."""
    wl, cfg = t_raft(), tcore.EngineConfig(**RAFT_KW)
    spec = fused.kernel_model(wl)
    assert spec.key == "raft" and 64 in spec.obs_pools
    space = tx.PlanSpace(raft_plan(tch))
    kids = [tx.mutate_plan(port_campaign.corpus[i % len(port_campaign.corpus)].plan, space,
                           tx.HostStream(int(k0), int(k1), PURPOSE_EXPLORE), max_ops=3)
            for i, (k0, k1) in enumerate(KEYS[:16])]
    seeds = np.asarray([e.seed for e in port_campaign.corpus[:16]] * 2, np.uint64)[:16]
    st = tcore.make_init(wl, cfg, device="cpu", plan_slots=space.slots, cov_words=16)(
        seeds, tch.stack_plan_rows(kids))
    lib = build_host_kernel(tmp_path_factory.mktemp("raft-obs-64"), spec, (64,), obs=True)
    want = state_to_numpy(tcore.make_run_while_plain(wl, cfg, 800, cov_words=16)(st))
    got = state_to_numpy(host_run(lib, wl, cfg, st, 800, True))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert want["cov"].any() and want["halted"].all()


def test_host_built_diskless_raftlog_taps_kernel_runs_the_hunt_plan(tmp_path_factory):
    """The explore soak's diskless-raftlog hunt library
    (``raftlog-record-nochaos``, pool 128, the taps kernel) under the
    hunt's crash storm and flapping partition with ``cov_words=64``:
    the g++ build equals the plain step in every field."""
    wl = tm.make_raftlog(record=True, chaos=False, durable=False)
    cfg = tcore.EngineConfig(pool_size=128, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
    spec = fused.kernel_model(wl)
    assert spec.key == "raftlog-record-nochaos" and spec.obs_pools == (128,)
    plan = tch.FaultPlan((
        tch.CrashStorm(targets=NODES, n=2, t_min_ns=150_000_000, t_max_ns=500_000_000,
                       down_min_ns=100_000_000, down_max_ns=400_000_000),
        tch.FlappingPartition(targets=NODES, n_cycles=2, t_min_ns=50_000_000,
                              t_max_ns=400_000_000, dur_min_ns=100_000_000,
                              dur_max_ns=300_000_000, up_min_ns=20_000_000,
                              up_max_ns=200_000_000),
    ), name="raftlog-hunt")
    seeds = np.arange(6, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    st = tcore.make_init(wl, cfg, device="cpu", plan_slots=plan.slots, cov_words=64)(
        seeds, plan.compile_batch(seeds, wl=wl))
    lib = build_host_kernel(tmp_path_factory.mktemp(spec.key), spec, (128,), obs=True)
    want = state_to_numpy(tcore.make_run_while_plain(wl, cfg, 1200, cov_words=64)(st))
    got = state_to_numpy(host_run(lib, wl, cfg, st, 1200, True))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert want["cov"].any() and (want["hist_count"] > 0).all()
