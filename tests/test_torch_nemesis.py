"""The nemesis loop in the torch port against the JAX package: a fault
plan's search, its shrink and the compacted runner under duplication.

On kvchaos ``bug=True, chaos=False`` (the lost-write mutant without the
model's own kill) at tests/test_chaos.py's shape, 64 seeds:
``search_seeds(plan=...)`` flags the JAX package's seeds with its traces
and ``plan_hash``, the clean model flags none, ``shrink_plan`` of the
first failing seed gives the JAX package's events, rounds and trace (and
its replay reproduces them), and a seed that does not fail is refused.
``make_run_compacted(dup_rows=True)`` on twophase-record under the
nemesis soak's crash-and-duplication plan banks the JAX package's
values. All on the plain step on the CPU; exact equality.
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest

import madsim_tpu.chaos as jc
import madsim_tpu.check as jcheck
import madsim_tpu.engine as je
from madsim_tpu.engine.compact import make_run_compacted as j_compacted
from madsim_tpu.models import make_kvchaos as j_kv
from madsim_tpu.models import make_twophase as j_twophase
from madsim_tpu_torch import chaos as tc
from madsim_tpu_torch import check as tcheck
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.compact import RESULT_FIELDS, make_run_compacted
from madsim_tpu_torch.engine.search import search_seeds
from madsim_tpu_torch.models import make_kvchaos as t_kv
from madsim_tpu_torch.models import make_twophase as t_twophase

N_SEEDS, CAP = 64, 3000
KV_KW = dict(pool_size=96, loss_p=0.02)


def nemesis_plan(m):
    """tests/test_chaos.py's kv nemesis plan."""
    return m.FaultPlan((m.CrashStorm(
        targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
        down_min_ns=50_000_000, down_max_ns=300_000_000),), name="kv-nemesis")


def lost_write(mod):
    def inv(h):
        return mod.stale_reads(h) & mod.read_your_writes(h)

    return inv


@pytest.fixture(scope="module")
def searches():
    """The JAX package's search and the port's, compact off and on."""
    j = je.search_seeds(j_kv(writes=5, record=True, bug=True, chaos=False),
                        je.EngineConfig(**KV_KW), None, n_seeds=N_SEEDS, max_steps=CAP,
                        history_invariant=lost_write(jcheck), plan=nemesis_plan(jc))
    wl, cfg = t_kv(writes=5, record=True, bug=True, chaos=False), tcore.EngineConfig(**KV_KW)
    t = {
        compact: search_seeds(wl, cfg, None, n_seeds=N_SEEDS, max_steps=CAP,
                              history_invariant=lost_write(tcheck), plan=nemesis_plan(tc),
                              compact=compact, device="cpu")
        for compact in (False, True)
    }
    return j, t


@pytest.mark.parametrize("compact", [False, True], ids=["lockstep", "compact"])
def test_plan_search_flags_the_reference_seeds(searches, compact):
    j, t = searches[0], searches[1][compact]
    assert j.failing_seeds.size > 0
    np.testing.assert_array_equal(t.failing_seeds, j.failing_seeds)
    for attr in ("ok", "halted", "overflowed", "traces"):
        np.testing.assert_array_equal(getattr(t, attr), np.asarray(getattr(j, attr)),
                                      err_msg=attr)
    assert t.plan_hash == j.plan_hash == nemesis_plan(tc).hash()
    assert t.banner() == j.banner()
    assert f"plan_hash={t.plan_hash}" in t.banner()


def test_the_clean_model_flags_none():
    rep = search_seeds(t_kv(writes=5, record=True, chaos=False), tcore.EngineConfig(**KV_KW),
                       None, n_seeds=N_SEEDS, max_steps=CAP,
                       history_invariant=lost_write(tcheck), plan=nemesis_plan(tc),
                       device="cpu")
    assert rep.failing_seeds.size == 0 and rep.unhalted_seeds.size == 0


def test_shrink_equals_the_reference_and_replays(searches):
    j_rep = searches[0]
    seed = int(j_rep.failing_seeds[0])
    want = jc.shrink_plan(j_kv(writes=5, record=True, bug=True, chaos=False),
                          je.EngineConfig(**KV_KW), seed, nemesis_plan(jc),
                          history_invariant=lost_write(jcheck), max_steps=CAP)
    wl, cfg = t_kv(writes=5, record=True, bug=True, chaos=False), tcore.EngineConfig(**KV_KW)
    got = tc.shrink_plan(wl, cfg, seed, nemesis_plan(tc),
                         history_invariant=lost_write(tcheck), max_steps=CAP, device="cpu")
    assert [tuple(vars(e).values()) for e in got.events] == [
        tuple(vars(e).values()) for e in want.events]
    assert (got.rounds, got.tested, got.trace, got.original_events) == (
        want.rounds, want.tested, want.trace, want.original_events)
    assert got.plan.hash() == want.plan.hash()
    assert got.banner() == want.banner()
    assert len(got.events) <= got.original_events
    # the shrunk (seed, config, plan) replays to the same failure and trace
    rep = search_seeds(wl, cfg, None, n_seeds=1, max_steps=CAP, seed_base=seed,
                       history_invariant=lost_write(tcheck), plan=got.plan, device="cpu")
    assert rep.failing_seeds.tolist() == [seed] and int(rep.traces[0]) == got.trace


def test_shrink_refuses_a_seed_that_does_not_fail(searches):
    t_rep = searches[1][False]
    passing = sorted(set(range(N_SEEDS)) - set(t_rep.failing_seeds.tolist()))
    wl, cfg = t_kv(writes=5, record=True, bug=True, chaos=False), tcore.EngineConfig(**KV_KW)
    with pytest.raises(ValueError, match="does not fail"):
        tc.shrink_plan(wl, cfg, passing[0], nemesis_plan(tc),
                       history_invariant=lost_write(tcheck), max_steps=CAP, device="cpu")
    with pytest.raises(ValueError, match="need an invariant"):
        tc.shrink_plan(wl, cfg, passing[0], nemesis_plan(tc), device="cpu")


def tp_plan(m):
    """The nemesis soak's twophase plan: a participant crash and a
    duplication window."""
    return m.FaultPlan((
        m.CrashStorm(targets=(1, 2, 3, 4), n=1, t_min_ns=20_000_000, t_max_ns=250_000_000,
                     down_min_ns=100_000_000, down_max_ns=400_000_000),
        m.Duplicate(t_min_ns=10_000_000, t_max_ns=300_000_000, dur_min_ns=50_000_000,
                    dur_max_ns=300_000_000),
    ), name="twophase-nemesis")


def test_compacted_run_with_duplication_equals_the_reference():
    kw, cap = dict(pool_size=96, loss_p=0.05), 4000
    seeds = np.arange(N_SEEDS, dtype=np.uint64)
    jp, tp = tp_plan(jc), tp_plan(tc)
    assert tp.uses_dup()
    jwl, twl = j_twophase(record=True, chaos=False), t_twophase(record=True, chaos=False)
    jst = je.make_init(jwl, je.EngineConfig(**kw), time32=False, plan_slots=jp.slots)(
        seeds, jp.compile_batch(seeds))
    want = j_compacted(jwl, je.EngineConfig(**kw), cap, layout="scatter", time32=False,
                       shrink=2, min_size=16, dup_rows=True)(jst)
    tst = tcore.make_init(twl, tcore.EngineConfig(**kw), device="cpu", plan_slots=tp.slots)(
        seeds, tp.compile_batch(seeds))
    got = make_run_compacted(twl, tcore.EngineConfig(**kw), cap, shrink=2, min_size=16,
                             dup_rows=True)(tst)
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                      err_msg=f)
    # the duplication rows were live: without them the run differs
    plain = make_run_compacted(twl, tcore.EngineConfig(**kw), cap, shrink=2,
                               min_size=16)(tst)
    assert not np.array_equal(plain.trace, got.trace)
