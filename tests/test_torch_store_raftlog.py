"""raftlog ``durable=True`` and ``bug="nosync"`` in the port, against
the JAX engine, the C++ oracle and the kernel's step code.

* ``durable=True`` with its own chaos, and ``durable=True,
  record=True, chaos=False`` under the store soak's plan, the lying disk
  and the EIO storm, and ``bug="nosync"`` under the store plan, through
  the plain step and the JAX engine (``make_run_while(layout="scatter",
  time32=False)``, ``metrics=True`` under the plans), equal in every
  field, the storage columns and ``met`` included.
* ``durable=True`` equals the C++ oracle's traces: syncing every
  durable write in the dispatch that made it is the oracle's
  verbatim-durable semantics.
* The run kernel's step code built with g++ is in
  ``test_torch_store_host.py``.

Exact equality throughout.
"""

import numpy as np
import pytest

import jax

import madsim_tpu.chaos as jc
import madsim_tpu.engine as je
import madsim_tpu.models.raftlog as jrl
from madsim_tpu_torch import chaos as tc
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.models import raftlog as trl

from _torch_parity import assert_oracle_traces, assert_same_state, needs_oracle
from _torch_store_pins import STORE_KW, store_plans

SEEDS = np.arange(32, dtype=np.uint64)

RL_SEEDS = SEEDS[:8]
JPLANS, TPLANS = store_plans(jc), store_plans(tc)


def _rl_both(fkw, kw, plan, seeds, cap, metrics=False):
    """raftlog through both engines under ``plan`` (a key of
    ``store_plans`` or None), equal per field; the port's state."""
    jw, tw = jrl.make_raftlog(**fkw), trl.make_raftlog(**fkw)
    jcfg, tcfg = je.EngineConfig(**kw), tcore.EngineConfig(**kw)
    slots = JPLANS[plan].slots if plan else 0
    jinit = je.make_init(jw, jcfg, time32=False, plan_slots=slots, metrics=metrics)
    tinit = tcore.make_init(tw, tcfg, device="cpu", plan_slots=slots, metrics=metrics)
    if plan:
        jst = jinit(seeds, JPLANS[plan].compile_batch(seeds))
        tst = tinit(seeds, TPLANS[plan].compile_batch(seeds, wl=tw))
    else:
        jst, tst = jinit(seeds), tinit(seeds)
    want = jax.jit(je.make_run_while(jw, jcfg, cap, layout="scatter", time32=False,
                                     metrics=metrics))(jst)
    got = tcore.make_run_while_plain(tw, tcfg, cap, metrics=metrics)(tst)
    assert_same_state(want, got)
    return state_to_numpy(got)


def test_raftlog_durable_with_its_own_chaos_equals_the_reference():
    t = _rl_both(dict(durable=True), dict(pool_size=64, loss_p=0.02), None, SEEDS, 4000)
    assert t["halted"].all() and t["disk"].shape == (32, 5, 12)
    # some seeds went through their kill; the synced image holds the log
    assert (t["epoch"].sum(1) >= 1).any() and (t["disk"][:, :, trl.LOGLEN] > 0).any()


RL_PLAN_CASES = {
    "store": (dict(record=True, chaos=False, durable=True), "store"),
    "lie": (dict(record=True, chaos=False, durable=True), "lie"),
    "eio": (dict(record=True, chaos=False, durable=True), "eio"),
    "nosync-store": (dict(record=True, chaos=False, durable=True, bug="nosync"), "store"),
}


@pytest.mark.parametrize("case", list(RL_PLAN_CASES))
def test_raftlog_under_storage_chaos_equals_the_reference(case):
    fkw, plan = RL_PLAN_CASES[case]
    t = _rl_both(fkw, STORE_KW, plan, RL_SEEDS, 6000, metrics=True)
    met = t["met"]
    assert t["overflow"].sum() == 0 and t["hist_drop"].sum() == 0
    if case == "store":
        assert met[:, tcore.MET_TORN].sum() > 0 and met[:, tcore.MET_SYNC].min() > 0
    if case == "lie":
        assert met[:, tcore.MET_SYNC_LOST].sum() > 0
    if case == "eio":
        assert (met[:, tcore.MET_SYNC_LOST] > 0).sum() > len(RL_SEEDS) // 2
    if case == "nosync-store":
        assert met[:, tcore.MET_SYNC].sum() == 0


@needs_oracle
def test_raftlog_durable_equals_the_oracle():
    """Sync-everywhere placement runs the oracle's verbatim-durable
    trajectory."""
    assert_oracle_traces(jrl.make_raftlog(durable=True), trl.make_raftlog(durable=True),
                         dict(pool_size=64, loss_p=0.02), 250)
