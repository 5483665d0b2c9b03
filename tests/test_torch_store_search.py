"""Searches and shrinks under storage faults, in the port against the
JAX package.

* ``search_seeds`` of raftlog ``bug="nosync"`` under the store soak's
  plan with the store invariant (election safety on commits and on
  elections, recovery safety) and ``metrics=True`` flags the JAX
  package's seeds, by committed-value loss, with its traces and ``met``.
* ``shrink_plan`` of a nosync failure under a crash storm gives the JAX
  package's events, rounds, candidates, plan hash and trace, and the
  shrunk plan replays to the same failure.

Exact equality throughout.
"""

import numpy as np

import madsim_tpu.chaos as jc
import madsim_tpu.check as jk
import madsim_tpu.engine as je
import madsim_tpu.models.raftlog as jrl
from madsim_tpu_torch import chaos as tc
from madsim_tpu_torch import check as tk
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.search import search_seeds as tcore_search
from madsim_tpu_torch.models import raftlog as trl

from _torch_store_pins import STORE_KW, store_inv, store_plans

JPLANS, TPLANS = store_plans(jc), store_plans(tc)
# the nosync mutant's first failing seed under the store plan (the JAX
# package's search over seeds 0..8191), and a window of seeds around it
NOSYNC_FIRST = 413
NOSYNC_SEEDS = np.arange(400, 464, dtype=np.uint64)


def test_store_search_equals_the_reference():
    """The nosync mutant under the store plan: ``search_seeds`` with the
    store invariant flags the JAX package's seeds, by committed-value
    loss."""
    fkw = dict(record=True, chaos=False, durable=True, bug="nosync")
    kw = dict(max_steps=6000, require_halt=False, seeds=NOSYNC_SEEDS, metrics=True)
    jbox, tbox = {}, {}
    want = je.search_seeds(jrl.make_raftlog(**fkw), je.EngineConfig(**STORE_KW), None,
                           history_invariant=store_inv(jk, jrl, jbox), plan=JPLANS["store"],
                           **kw)
    got = tcore_search(trl.make_raftlog(**fkw), tcore.EngineConfig(**STORE_KW), None,
                       history_invariant=store_inv(tk, trl, tbox), plan=TPLANS["store"],
                       device="cpu", **kw)
    assert NOSYNC_FIRST in got.failing_seeds
    for attr in ("failing_seeds", "ok", "halted", "traces", "overflowed", "met"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr), err_msg=attr)
    assert got.plan_hash == want.plan_hash
    np.testing.assert_array_equal(tbox["commit"], jbox["commit"])
    assert not tbox["commit"].all()


# a crash storm of three kills under which the nosync mutant fails on
# seed 37 (the JAX package's search over seeds 0..511): a shrink small
# enough for the CPU
CRASH3 = dict(targets=(0, 1, 2, 3, 4), n=3, t_min_ns=150_000_000, t_max_ns=400_000_000,
              down_min_ns=50_000_000, down_max_ns=200_000_000)


def test_shrink_of_a_nosync_failure_equals_the_reference():
    fkw = dict(record=True, chaos=False, durable=True, bug="nosync")
    jplan = jc.FaultPlan((jc.CrashStorm(**CRASH3),), name="crash3")
    tplan = tc.FaultPlan((tc.CrashStorm(**CRASH3),), name="crash3")
    want = jc.shrink_plan(jrl.make_raftlog(**fkw), je.EngineConfig(**STORE_KW), 37, jplan,
                          history_invariant=store_inv(jk, jrl, {}), max_steps=6000)
    wl, cfg = trl.make_raftlog(**fkw), tcore.EngineConfig(**STORE_KW)
    got = tc.shrink_plan(wl, cfg, 37, tplan, history_invariant=store_inv(tk, trl, {}),
                         max_steps=6000, device="cpu")
    assert [tuple(vars(e).values()) for e in got.events] == [
        tuple(vars(e).values()) for e in want.events]
    assert (got.rounds, got.tested, got.trace, got.plan.hash(), got.banner()) == (
        want.rounds, want.tested, want.trace, want.plan.hash(), want.banner())
    # the shrunk plan replays to the same committed-value loss
    box = {}
    rep = tcore_search(wl, cfg, None, seeds=np.asarray([37], np.uint64), max_steps=6000,
                       history_invariant=store_inv(tk, trl, box), plan=got.plan,
                       require_halt=False, device="cpu")
    assert rep.failing_seeds.tolist() == [37] and int(rep.traces[0]) == got.trace
