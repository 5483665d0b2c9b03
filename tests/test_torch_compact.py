"""The port's seed compaction against the JAX package's.

The port's phase program (the plain step on the CPU) equals the
reference's ``make_run_compacted`` on every banked field, ``step``
included, for raft, kvchaos with the payload arena and shardkv, at the
step cap, in a single-phase schedule and in one that carries halted
riders into a later phase. The card path's ``step`` is rebuilt by
``bank_steps`` from each seed's stop-at-halt count; here it is held
against the phase program with the counts of the plain step, and the
card path's banks with one stop-at-halt launch of the run kernel's code
built for the host. Exact equality: the engine is integer arithmetic.
"""

import numpy as np
import pytest
import torch

import madsim_tpu.engine as je
from madsim_tpu.engine.compact import RESULT_FIELDS as J_RESULT_FIELDS
from madsim_tpu.models import make_kvchaos as j_kvchaos
from madsim_tpu.models import make_raft as j_raft
from madsim_tpu.models import make_shardkv as j_shardkv
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.check.device import election_safety
from madsim_tpu_torch.engine.compact import (
    RESULT_FIELDS,
    _phase_sizes,
    bank_steps,
    make_run_compacted,
    make_run_compacted_plain,
    one_launch_banks,
)
from madsim_tpu_torch.models import BENCH_SPECS, SOAK_SPECS, make_kvchaos, make_raft, make_shardkv
from madsim_tpu_torch.models.raft import OP_ELECT

from _torch_host import build_host_kernel, host_launch

N_SEEDS = 64
RAFT_KW = BENCH_SPECS["raft"][1]
# name -> (JAX factory, port factory, engine kwargs, cap, shrink, min_size)
CASES = {
    "raft": (j_raft, make_raft, RAFT_KW, 600, 2, 8),
    "kvchaos-payload": (
        lambda: j_kvchaos(payload=True), lambda: make_kvchaos(payload=True),
        BENCH_SPECS["kvchaos"][1], BENCH_SPECS["kvchaos"][3], 2, 8,
    ),
    "shardkv": (j_shardkv, make_shardkv, SOAK_SPECS["shardkv"][1],
                SOAK_SPECS["shardkv"][3], 2, 8),
    # rows still live when the cap hits
    "raft-cap9": (j_raft, make_raft, RAFT_KW, 9, 2, 8),
    # min_size >= n_seeds: one phase
    "raft-single-phase": (j_raft, make_raft, RAFT_KW, 600, 2, N_SEEDS),
    # phase ends where fewer rows are live than the next size holds
    "raft-riders": (j_raft, make_raft, RAFT_KW, 600, 4, 2),
}


def _plain_counts(wl, cfg, cap, st):
    """Each seed's steps until it halts, at most ``cap``: what the run
    kernel's stop-at-halt pass reports, from the plain step."""
    step = tcore.make_step_plain(wl, cfg)
    counts, i = torch.zeros_like(st.now), 0
    while i < cap and not bool(st.halted.all()):
        counts += (~st.halted).to(torch.int64)
        st, i = step(st), i + 1
    return counts.numpy()


def _riders(counts, bank, cap):
    """Rows banked after the first phase end at or past their halt."""
    ends = np.unique(bank)
    first_end = np.array([ends[ends >= c].min() for c in counts])
    return int(((counts < cap) & (bank > first_end)).sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_phase_program_matches_reference_every_field(case):
    jf, tf, kw, cap, shrink, min_size = CASES[case]
    seeds = np.arange(N_SEEDS, dtype=np.uint64)
    jwl, jcfg = jf(), je.EngineConfig(**kw)
    ref = je.make_run_compacted(jwl, jcfg, cap, time32=False, shrink=shrink, min_size=min_size)(
        je.make_init(jwl, jcfg, time32=False)(seeds)
    )
    wl, cfg = tf(), tcore.EngineConfig(**kw)
    st = tcore.make_init(wl, cfg, device="cpu")(seeds)
    out = make_run_compacted(wl, cfg, cap, shrink=shrink, min_size=min_size)(st)
    for f in RESULT_FIELDS:
        want, got = getattr(ref, f), getattr(out, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in set(J_RESULT_FIELDS) - set(RESULT_FIELDS):
        other = getattr(ref, f)
        assert other.size == 0 or not other.any(), f

    # the card path's step: the schedule replayed on the counts
    counts = _plain_counts(wl, cfg, cap, st)
    bank = bank_steps(counts, _phase_sizes(N_SEEDS, shrink, min_size), cap)
    np.testing.assert_array_equal((st.step.numpy() + bank) & 0xFFFFFFFF, out.step.astype(np.int64))
    halted = out.halted.all()
    assert halted == (case != "raft-cap9")
    if case == "raft-riders":
        assert _riders(counts, bank, cap) > 0


@pytest.mark.parametrize("cap,shrink,min_size", [(600, 2, 1), (15, 2, 4), (0, 2, 8), (600, 3, 5)])
def test_rebuilt_step_equals_phase_program(cap, shrink, min_size):
    """bank_steps on the plain stop-at-halt counts gives the phase
    program's step, over more schedules than the reference compiles."""
    wl, cfg = make_raft(), tcore.EngineConfig(**RAFT_KW)
    st = tcore.make_init(wl, cfg, device="cpu")(np.arange(N_SEEDS, dtype=np.uint64) * np.uint64(31))
    out = make_run_compacted_plain(wl, cfg, cap, shrink=shrink, min_size=min_size)(st)
    counts = _plain_counts(wl, cfg, cap, st)
    bank = bank_steps(counts, _phase_sizes(N_SEEDS, shrink, min_size), cap)
    np.testing.assert_array_equal(bank, out.step.astype(np.int64))


def test_fields_select_the_banked_outputs_and_other_fields_equal_lockstep():
    wl, cfg = make_raft(), tcore.EngineConfig(**RAFT_KW)
    st = tcore.make_init(wl, cfg, device="cpu")(np.arange(N_SEEDS, dtype=np.uint64))
    run = make_run_compacted(wl, cfg, 600, min_size=8, fields=("now", "halted"))
    banks = run.compute(st)
    assert all(set(b) == {"now", "halted", "_idx"} for b in banks)
    out = run.assemble(banks)
    lock = tcore.make_run_while(wl, cfg, 600)(st)
    np.testing.assert_array_equal(out.now, lock.now.numpy())
    np.testing.assert_array_equal(out.halted, lock.halted.numpy())


def test_arguments_are_validated():
    wl, cfg = make_raft(), tcore.EngineConfig(**RAFT_KW)
    with pytest.raises(ValueError, match="shrink"):
        make_run_compacted(wl, cfg, 10, shrink=1)
    with pytest.raises(ValueError, match="min_size"):
        make_run_compacted(wl, cfg, 10, min_size=0)
    with pytest.raises(ValueError, match="unknown result field"):
        make_run_compacted(wl, cfg, 10, fields=("now", "bogus"))
    # the history, coverage and ring columns are banked now (zero-size
    # for raft without the taps)
    make_run_compacted(wl, cfg, 10, fields=("hist_count", "cov", "tl_t"))
    # so are the latency sketch and its counters; the per-op clocks are not
    make_run_compacted(wl, cfg, 10, fields=("lat_hist", "lat_count", "lat_drop"))
    with pytest.raises(ValueError, match="unknown result field"):
        make_run_compacted(wl, cfg, 10, fields=("lat_inv",))
    # causal is ported: the final clocks and the ring's causal columns
    # are banked
    got = make_run_compacted(wl, cfg, 10, causal=True, timeline_cap=8)(
        tcore.make_init(wl, cfg, device="cpu", causal=True, timeline_cap=8)(np.arange(2)))
    assert got.lam.shape == (2, 5) and got.lam.any() and got.tl_seq.shape == (2, 8)
    # so is retry: a compacted run under a client army's policy banks the
    # plain step's results (no retry columns: met carries the counters),
    # and a state built for another policy is refused
    from madsim_tpu_torch.chaos import FaultPlan, RetryPolicy
    from madsim_tpu_torch.models import kvchaos

    kwl = make_kvchaos(writes=4, n_replicas=2, chaos=False, army=True)
    plan = FaultPlan((kvchaos.client_army(n_ops=4, t_min_ns=5_000_000, t_max_ns=80_000_000,
                                          n_replicas=2, retry=RetryPolicy(timeout_ns=5_000_000)),))
    rt, kcfg = plan.retry_spec(), tcore.EngineConfig(pool_size=48)
    seeds = np.arange(3, dtype=np.uint64)
    st = tcore.make_init(kwl, kcfg, device="cpu", plan_slots=plan.slots, metrics=True,
                         retry=rt)(seeds, plan.compile_batch(seeds, wl=kwl))
    got = make_run_compacted(kwl, kcfg, 400, min_size=2, metrics=True, retry=rt)(st)
    want = state_to_numpy(tcore.make_run_while(kwl, kcfg, 400, metrics=True, retry=rt)(st))
    assert want["met"][:, tcore.MET_RETRY].sum() > 0
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), want[f], err_msg=f)
    with pytest.raises(ValueError, match="retry columns for 4 ops"):
        make_run_compacted(kwl, kcfg, 400, metrics=True)(st)
    # hist_screen is validated, not refused: it needs histories and the
    # four history fields banked
    with pytest.raises(ValueError, match="Workload.history=None"):
        make_run_compacted(wl, cfg, 10, hist_screen=election_safety(OP_ELECT))
    with pytest.raises(ValueError, match=r"missing \['hist_t'\]"):
        make_run_compacted(make_raft(record=True), cfg, 10, hist_screen=election_safety(OP_ELECT),
                           fields=("now", "hist_word", "hist_count", "hist_drop"))


@pytest.fixture(scope="module")
def raft_host_lib(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp("raft_compact_host"),
                             fused.MODELS["raft"], (RAFT_KW["pool_size"],))


@pytest.mark.parametrize("cap,shrink,min_size", [(600, 2, 8), (600, 4, 2), (9, 2, 8)])
def test_one_stop_at_halt_launch_gives_the_phase_program(raft_host_lib, cap, shrink, min_size):
    """The card path's banks, from one stop-at-halt launch of the run
    kernel's code (built for the host with g++), equal the phase
    program's in every field, step included."""
    wl, cfg = make_raft(), tcore.EngineConfig(**RAFT_KW)
    st = tcore.make_init(wl, cfg, device="cpu")(np.arange(N_SEEDS, dtype=np.uint64) * np.uint64(7))
    out, iters, _tmax = host_launch(raft_host_lib, wl, cfg, st, cap, True)
    run = make_run_compacted_plain(wl, cfg, cap, shrink=shrink, min_size=min_size)
    got = run.assemble(one_launch_banks(st, out, iters, RESULT_FIELDS))
    want = run(st)
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
