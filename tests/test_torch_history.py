"""Operation histories in the torch port against the JAX package.

The copied checkers (``madsim_tpu_torch/check``) on the reference's own
checker cases (``tests/test_check.py``) and on random histories; the
recording surface (``HistorySpec``, ``EmitBuilder.record``, hand-built
``Emits``); the plain step's history append at a capacity that
overflows; the determinism checks over the history columns; and the run
kernel's history axis built for the host (raft-record and kvchaos-bug)
against the plain step, every history row included. Exact equality.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import madsim_tpu.check as jcheck
from madsim_tpu.models import make_kvchaos as j_kv
from madsim_tpu_torch import check as tcheck
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.engine.verify import (
    DeterminismError, check_determinism, compare_traces,
)
from madsim_tpu_torch.models import BENCH_SPECS
from madsim_tpu_torch.models import make_kvchaos as t_kv
from madsim_tpu_torch.models import make_raft as t_raft

import test_check
from _torch_host import build_host_kernel, host_launch, host_run
from _torch_parity import run_both

KV_KW = BENCH_SPECS["kvchaos"][1]
RAFT_KW = BENCH_SPECS["raft"][1]
SEEDS = np.arange(24, dtype=np.uint64) * np.uint64(7919)


# ---------------------------------------------------------------------------
# the copied checkers
# ---------------------------------------------------------------------------

# the reference's checker cases that need no engine: synthetic histories
# through the linearizability checker, the pairing and the detectors
CHECKER_CASES = [
    (cls.__name__, name)
    for cls in (test_check.TestCheckRegister, test_check.TestCheckKv,
                test_check.TestBatchHistoryOps, test_check.TestVectorized)
    for name in sorted(vars(cls)) if name.startswith("test_")
]


def _with_port_checkers():
    """test_check's namespace with every name of the check package bound
    to the port's copy, and its helpers rebuilt over that namespace."""
    g = dict(vars(test_check))
    g.update({n: getattr(tcheck, n) for n in tcheck.__all__ if n in g})
    for name, obj in list(g.items()):
        if isinstance(obj, types.FunctionType) and obj.__module__ == test_check.__name__:
            g[name] = types.FunctionType(obj.__code__, g, name, obj.__defaults__)
    return g


@pytest.mark.parametrize("case", CHECKER_CASES, ids=[f"{c}.{n}" for c, n in CHECKER_CASES])
def test_copied_checkers_pass_the_reference_cases(case):
    cls_name, name = case
    cls = getattr(test_check, cls_name)
    fn = getattr(cls, name)
    g = _with_port_checkers()
    port_case = types.FunctionType(fn.__code__, g, name, fn.__defaults__)
    assert port_case.__globals__["BatchHistory"] is tcheck.BatchHistory
    port_case(cls())


def _random_history(mod, rng, s=96, h=20):
    """Random records of the ops the detectors read, in time order."""
    ops = np.array([mod.OP_WRITE, mod.OP_READ, mod.OP_USER, mod.OP_USER + 1,
                    mod.OP_USER + 2, mod.OP_USER + 3])
    word = np.stack([
        rng.choice(ops, (s, h)), rng.integers(0, 3, (s, h)),
        rng.integers(0, 6, (s, h)), rng.integers(0, 3, (s, h)),
        rng.choice([mod.OK_PENDING, mod.OK_FAIL, mod.OK_OK], (s, h), p=[0.4, 0.1, 0.5]),
    ], axis=2).astype(np.int32)
    t = np.sort(rng.integers(0, 10**6, (s, h)), axis=1).astype(np.int64)
    count = rng.integers(0, h + 1, s).astype(np.int32)
    return mod.BatchHistory(word=word, t=t, count=count, drop=np.zeros(s, np.int32))


def _verdict(fn, h):
    try:
        return np.asarray(fn(h)).tolist()
    except Exception as e:  # noqa: BLE001 - both copies must fail alike
        return type(e).__name__


@pytest.mark.parametrize("seed", [0, 1])
def test_copied_detectors_give_the_reference_verdicts_on_random_histories(seed):
    u = tcheck.OP_USER
    detectors = {
        "stale_reads": lambda m: m.stale_reads,
        "read_your_writes": lambda m: m.read_your_writes,
        "monotonic_reads": lambda m: m.monotonic_reads,
        "monotonic_reads_strict": lambda m: m.vectorized.monotonic_reads_strict,
        "election_safety": lambda m: lambda h: m.election_safety(h, elect_op=u),
        "lease_safety": lambda m: lambda h: m.lease_safety(h, u, u + 1),
        "shard_coverage": lambda m: lambda h: m.shard_coverage(h, u + 1, u),
        "exactly_once": lambda m: lambda h: m.exactly_once(h, u + 2),
        "recovery_safety": lambda m: lambda h: m.vectorized.recovery_safety(h, u + 2, u + 3),
        "collapse_retries": lambda m: lambda h: m.collapse_retries(h).count,
    }
    for name, get in detectors.items():
        jv = _verdict(get(jcheck), _random_history(jcheck, np.random.default_rng(seed)))
        tv = _verdict(get(tcheck), _random_history(tcheck, np.random.default_rng(seed)))
        assert tv == jv, name
    jh = _random_history(jcheck, np.random.default_rng(seed))
    th = _random_history(tcheck, np.random.default_rng(seed))
    for i in range(16):
        jops, tops = jh.ops(i, strict=False), th.ops(i, strict=False)
        assert [tuple(vars(o).values()) for o in tops] == [tuple(vars(o).values()) for o in jops]
        assert _verdict(lambda _h: tcheck.check_kv(tops).ok, None) == \
            _verdict(lambda _h: jcheck.check_kv(jops).ok, None)


# ---------------------------------------------------------------------------
# the recording surface
# ---------------------------------------------------------------------------


def test_history_spec_and_record_validate_like_the_reference():
    with pytest.raises(ValueError, match="capacity must be >= 1"):
        tcore.HistorySpec(capacity=0)
    with pytest.raises(ValueError, match="max_records must be >= 1"):
        tcore.HistorySpec(capacity=4, max_records=0)
    eb = tcore.EmitBuilder(2, 0, 2, 3, "cpu")
    with pytest.raises(ValueError, match="needs history slots"):
        eb.record(1)
    eb = tcore.EmitBuilder(2, 0, 2, 3, "cpu", r=1)
    eb.record(1, key=2, arg=3, ok=-1, when=torch.tensor([True, False, True]))
    with pytest.raises(ValueError, match="more than max_records=1"):
        eb.record(1)
    em = eb.build()
    assert em.rec_valid.tolist() == [[True], [False], [True]]
    assert em.rec[0, 0].tolist() == [1, 2, 3, -1]
    with pytest.raises(ValueError, match="at most 31 writes"):
        t_kv(writes=32, record=True)
    with pytest.raises(ValueError, match="requires record=True"):
        t_kv(bug=True)


def _hand_built(record_rows):
    """raft-record whose timeout handler returns hand-built Emits with
    ``record_rows`` record rows (None: no record fields at all)."""
    wl = t_raft(record=True)

    def on_timeout(ctx):
        new, em = wl.handlers[1](ctx)
        if record_rows is None:
            em.rec_valid = em.rec = None
        else:
            s = ctx.state.shape[0]
            em.rec_valid = torch.ones((s, record_rows), dtype=torch.bool)
            em.rec = torch.ones((s, record_rows, 4), dtype=torch.int32)
        return new, em

    handlers = list(wl.handlers)
    handlers[1] = on_timeout
    return dataclasses.replace(wl, handlers=tuple(handlers))


def test_hand_built_emits_record_nothing_and_wrong_rows_raise():
    cfg = tcore.EngineConfig(**RAFT_KW)
    st = tcore.make_init(t_raft(record=True), cfg, device="cpu")(SEEDS[:8])
    want = state_to_numpy(tcore.make_run_while(t_raft(record=True), cfg, 600)(st))
    got = state_to_numpy(tcore.make_run_while(_hand_built(None), cfg, 600)(st))
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    with pytest.raises(ValueError, match="2 history-record rows"):
        tcore.make_run(_hand_built(2), cfg, 5)(st)


# ---------------------------------------------------------------------------
# overflow and the determinism checks
# ---------------------------------------------------------------------------


def test_capacity_overflow_matches_reference_and_counts_drops():
    """kvchaos-bug at capacity 6: the first six records kept, the rest
    counted in hist_drop, every row and counter equal to the JAX
    engine's."""
    t = run_both(j_kv(record=True, bug=True, hist_capacity=6),
                 t_kv(record=True, bug=True, hist_capacity=6), KV_KW, SEEDS[:16],
                 BENCH_SPECS["kvchaos"][3], until_halted=True)
    assert (t["hist_count"] == 6).all() and (t["hist_drop"] > 0).all()


def test_compare_traces_catches_a_flipped_history_word():
    wl, cfg = t_raft(record=True), tcore.EngineConfig(**RAFT_KW)
    a = tcore.make_run_while(wl, cfg, 600)(tcore.make_init(wl, cfg, device="cpu")(SEEDS))
    check_determinism(wl, cfg, SEEDS, 600, device="cpu")
    b = tcore.SimState(**{f: getattr(a, f).clone() for f in tcore.STATE_FIELDS})
    compare_traces(a, b)
    b.hist_word[5, 0, 2] ^= 1
    with pytest.raises(DeterminismError, match=r"history field 'hist_word' diverged at seed index 5"):
        compare_traces(a, b)
    compare_traces(a, b, history=False)  # the traces themselves agree


# ---------------------------------------------------------------------------
# the run kernel's history axis, built for the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("history_host")
    return {
        name: build_host_kernel(d, fused.MODELS[key], fused.MODELS[key].pools)
        for name, key in (("raft-election-record", "raft-record"), ("kvchaos-bug", "kvchaos-bug"))
    }


def _seeded_rows(st, rng):
    """``st`` with history rows past hist_count filled with noise, as a
    resumed checkpoint's might be: the kernel must carry them through."""
    st.hist_word = torch.from_numpy(rng.integers(-9, 9, tuple(st.hist_word.shape)).astype(np.int32))
    st.hist_t = torch.from_numpy(rng.integers(0, 10**9, tuple(st.hist_t.shape)))
    return st


CASES = {
    "raft-election-record": (lambda **k: t_raft(record=True), RAFT_KW, 600),
    "kvchaos-bug": (lambda **k: t_kv(record=True, bug=True, **k), KV_KW, 900),
}


# raft records one win a seed, so kvchaos alone overflows its capacity
HOST_CASES = [(name, mode) for name in sorted(CASES)
              for mode in ("run_while", "fixed", "noisy_rows")] + [("kvchaos-bug", "overflow")]


@pytest.mark.parametrize("name,mode", HOST_CASES)
def test_host_built_record_kernel_matches_plain_step(host_libs, name, mode):
    factory, kw, cap = CASES[name]
    wl = factory(hist_capacity=6) if mode == "overflow" else factory()
    cfg = tcore.EngineConfig(**kw)
    st = tcore.make_init(wl, cfg, device="cpu")(SEEDS)
    if mode == "noisy_rows":
        st = _seeded_rows(st, np.random.default_rng(3))
    n_steps, until = (40, False) if mode == "fixed" else (cap, True)
    run = tcore.make_run_while_plain if until else tcore.make_run_plain
    want = state_to_numpy(run(wl, cfg, n_steps)(st))
    got = state_to_numpy(host_run(host_libs[name], wl, cfg, st, n_steps, until))
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert want["hist_count"].max() > 0
    if mode == "overflow":
        assert (want["hist_drop"] > 0).all()


def test_a_record_workload_needs_a_record_library():
    cfg = tcore.EngineConfig(**RAFT_KW)
    wl = t_raft(record=True)
    st = tcore.make_init(wl, cfg, device="cpu")(SEEDS[:4])
    assert fused.kernel_model(wl).key == "raft-record"
    with pytest.raises(NotImplementedError, match="records 0 history rows"):
        fused.check_state(fused.MODELS["raft"], wl, st)
    with pytest.raises(NotImplementedError, match="compiled for 'kvchaos-record'"):
        fused.kernel_model(dataclasses.replace(t_kv(record=True),
                                               history=tcore.HistorySpec(8, 2)))


def test_host_built_compacted_card_path_banks_the_history(host_libs):
    """The compacted runner's card path (one stop-at-halt launch, its
    banks assembled on the host), g++-built, banks the same history
    columns as the phase program with the plain step."""
    from madsim_tpu_torch.engine.compact import (
        RESULT_FIELDS, make_run_compacted_plain, one_launch_banks,
    )

    wl, cfg = t_kv(record=True, bug=True), tcore.EngineConfig(**KV_KW)
    st = tcore.make_init(wl, cfg, device="cpu")(SEEDS)
    out, iters, _tmax = host_launch(host_libs["kvchaos-bug"], wl, cfg, st, 900, True)
    run = make_run_compacted_plain(wl, cfg, 900, shrink=2, min_size=4)
    got = run.assemble(one_launch_banks(st, out, iters, RESULT_FIELDS))
    want = run(st)
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert want.hist_count.min() > 0
