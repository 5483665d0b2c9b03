"""Storage faults in the port's step, against the JAX package's.

* The two-phase sync discipline (``Workload.durable_sync``) on the store
  probe of ``tests/test_store.py`` (one node, durable columns 1-3, one
  write at 10 ms, a sync or none): the cases of its
  ``TestSyncDiscipline`` and the no-op case of ``TestDiskFaultSpec``,
  and an EIO case whose handler reads ``ctx.sync_err``, each through
  the plain step and the JAX engine (``make_run_while(layout="scatter",
  time32=False, metrics=True)``), equal in every field, the storage
  columns and ``met`` included.
* raftlog's ``durable`` and ``bug="nosync"`` variants against the JAX
  package's factory (``test_torch_store_raftlog.py`` runs them,
  ``test_torch_store_search.py`` searches and shrinks them).

Exact equality throughout: the engine is integer arithmetic.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import madsim_tpu.chaos as jc
import madsim_tpu.engine as je
import madsim_tpu.models.raftlog as jrl
from madsim_tpu_torch import chaos as tc
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.models import raftlog as trl

from _torch_parity import assert_same_state

SEEDS = np.arange(64, dtype=np.uint64)
PROBE_KW = dict(pool_size=16)
WRITE_VALS = (11, 22, 33)


# ---------------------------------------------------------------------------
# the store probe, in both packages
# ---------------------------------------------------------------------------


def make_probes(sync_call: bool, durable_sync: bool = True, eio_aware: bool = False):
    """tests/test_store.py's probe in both packages: handler 1 writes
    (11, 22, 33) into the durable columns at about 10 ms and syncs if
    ``sync_call``. ``eio_aware``: a node that sees ``ctx.sync_err``
    writes only its volatile column 0 (the count of withheld writes) and
    retries 10 ms later."""
    def make(core, write, mark_eio, err_of):
        def on_init(ctx):
            eb = ctx.emits()
            eb.after(10_000_000, core.user_kind(1), 0, when=(ctx.now == 0))
            return ctx.state, eb.build()

        def on_write(ctx):
            eb = ctx.emits()
            if not eio_aware:
                if sync_call:
                    eb.sync()
                return write(ctx.state), eb.build()
            err = err_of(ctx)
            eb.sync(when=~err)
            eb.after(10_000_000, core.user_kind(1), 0, when=err)
            return mark_eio(ctx.state, write(ctx.state), err), eb.build()

        return core.Workload(
            name=f"store-probe-{int(sync_call)}-{int(durable_sync)}-{int(eio_aware)}",
            n_nodes=1, state_width=4, handlers=(on_init, on_write), max_emits=2,
            durable_cols=(1, 2, 3), durable_sync=durable_sync,
        )

    def j_write(st):
        for j, v in enumerate(WRITE_VALS):
            st = st.at[1 + j].set(v)
        return st

    def t_write(st):
        return tcore.set_cols(st, torch.ones(st.shape[0], dtype=torch.bool),
                              {1 + j: v for j, v in enumerate(WRITE_VALS)})

    def j_mark(st, new, err):
        return jnp.where(err, st.at[0].add(1), new)

    def t_mark(st, new, err):
        return torch.where(err[:, None], tcore.set_cols(st, err, {0: st[:, 0] + 1}), new)

    jw = make(je, j_write, j_mark, lambda ctx: ctx.sync_err)
    tw = make(tcore, t_write, t_mark, lambda ctx: ctx.sync_err)
    return jw, tw


def _events(m, *evs):
    return m.LiteralPlan(events=tuple(m.FaultEvent(t=t, kind=k, a0=a0, a1=a1)
                                      for t, k, a0, a1 in evs))


KILL = ((50_000_000, tcore.KIND_KILL, 0, 0),)
RESTART = KILL + ((120_000_000, tcore.KIND_RESTART, 0, 0),)
LIE = ((1_000, tcore.KIND_SYNC_LOSS, 0, 0),) + KILL
HEAL = ((1_000, tcore.KIND_SYNC_LOSS, 0, 0), (5_000_000, tcore.KIND_SYNC_OK, 0, 0)) + KILL
TORN = ((1_000, tcore.KIND_TORN_ON, 0, 0),) + KILL
TORN_OFF = ((1_000, tcore.KIND_TORN_ON, 0, 0), (5_000_000, tcore.KIND_TORN_OFF, 0, 0)) + KILL
# an EIO window over the first write, closed before the retry at 20 ms;
# every node (-1) selected
EIO = ((1_000, tcore.KIND_SYNC_LOSS, -1, 1), (15_000_000, tcore.KIND_SYNC_OK, -1, 0)) + RESTART


def _disk_noop(m):
    return m.FaultPlan((m.DiskFault(targets=(0,), n_torn=1, n_sync_loss=1, t_min_ns=1_000,
                                    t_max_ns=2_000, dur_min_ns=1_000_000,
                                    dur_max_ns=2_000_000),))


# case -> (probe kwargs, literal events or a plan factory, the durable
# columns every seed ends with, or None where the torn prefix varies)
PROBE_CASES = {
    "synced_write_survives_kill": (dict(sync_call=True), KILL, WRITE_VALS),
    "unsynced_write_lost_on_kill": (dict(sync_call=False), KILL, (0, 0, 0)),
    "sync_loss_window_makes_sync_lie": (dict(sync_call=True), LIE, (0, 0, 0)),
    "closed_sync_loss_window_commits": (dict(sync_call=True), HEAL, WRITE_VALS),
    "torn_kill_keeps_prefix_of_last_write": (dict(sync_call=False), TORN, None),
    "closed_torn_window_is_a_clean_loss": (dict(sync_call=False), TORN_OFF, (0, 0, 0)),
    "torn_never_tears_synced_state": (dict(sync_call=True), TORN, WRITE_VALS),
    "discipline_off_keeps_verbatim_semantics": (
        dict(sync_call=False, durable_sync=False), KILL, WRITE_VALS),
    "always_synced_restart": (dict(sync_call=True), RESTART, WRITE_VALS),
    "sync_flag_ignored_without_discipline": (
        dict(sync_call=True, durable_sync=False), KILL, WRITE_VALS),
    "disk_faults_are_noops_without_discipline": (
        dict(sync_call=False, durable_sync=False), _disk_noop, WRITE_VALS),
    "eio_window_seen_by_the_handler": (dict(sync_call=True, eio_aware=True), EIO, WRITE_VALS),
}


def run_probe(probe_kw, plan_of, metrics=True, seeds=SEEDS):
    """The probe under the plan through both engines, equal per field;
    the port's final state as numpy."""
    jw, tw = make_probes(**probe_kw)
    if callable(plan_of):
        jplan, tplan = plan_of(jc), plan_of(tc)
    else:
        jplan, tplan = _events(jc, *plan_of), _events(tc, *plan_of)
    jcfg, tcfg = je.EngineConfig(**PROBE_KW), tcore.EngineConfig(**PROBE_KW)
    jst = je.make_init(jw, jcfg, time32=False, plan_slots=jplan.slots, metrics=metrics)(
        seeds, jplan.compile_batch(seeds))
    tst = tcore.make_init(tw, tcfg, device="cpu", plan_slots=tplan.slots, metrics=metrics)(
        seeds, tplan.compile_batch(seeds))
    assert_same_state(jst, tst)
    want = jax.jit(je.make_run_while(jw, jcfg, 60, layout="scatter", time32=False,
                                     metrics=metrics))(jst)
    got = tcore.make_run_while_plain(tw, tcfg, 60, metrics=metrics)(tst)
    assert_same_state(want, got)
    return state_to_numpy(got)


@pytest.mark.parametrize("case", list(PROBE_CASES))
def test_sync_discipline_equals_the_reference(case):
    probe_kw, plan_of, durable = PROBE_CASES[case]
    out = run_probe(probe_kw, plan_of)
    rows = out["node_state"][:, 0, 1:]
    if durable is not None:
        assert (rows == durable).all()
    else:
        prefixes = {WRITE_VALS[:k] + (0,) * (3 - k) for k in range(4)}
        got = {tuple(int(x) for x in r) for r in rows}
        assert got <= prefixes and len(got) >= 2
        assert (out["met"][:, tcore.MET_TORN] == 1).all()
    met = out["met"]
    on = probe_kw.get("durable_sync", True)
    assert out["disk"].shape[1] == (1 if on else 0)
    if case == "synced_write_survives_kill":
        assert (met[:, tcore.MET_SYNC] == 1).all() and (met[:, tcore.MET_SYNC_LOST] == 0).all()
        assert (met[:, tcore.MET_CRASH] == 1).all()
    if case == "sync_loss_window_makes_sync_lie":
        assert (met[:, tcore.MET_SYNC_LOST] == 1).all() and (met[:, tcore.MET_SYNC] == 0).all()
        assert (out["disk"][:, 0, 1:] == 0).all() and out["sync_loss"].all()
    if case == "eio_window_seen_by_the_handler":
        # the first write saw the window and was withheld, the retry synced
        assert (out["node_state"][:, 0, 0] == 0).all()  # volatile: reset by the restart
        assert (met[:, tcore.MET_SYNC] == 1).all() and (met[:, tcore.MET_SYNC_LOST] == 0).all()
        assert not out["sync_eio"].any()
    if not on:
        assert (met[:, tcore.MET_SYNC] == 0).all()
    # the probe never halts: its pool empties
    assert (met[:, tcore.MET_HALT_CODE] == tcore.HALT_IDLE).all()


def test_always_synced_equals_verbatim():
    """Sync-every-write under the discipline runs the trajectory of the
    verbatim-durable semantics (the oracle-compatibility contract)."""
    synced = run_probe(dict(sync_call=True), RESTART, metrics=False)
    verbatim = run_probe(dict(sync_call=False, durable_sync=False), RESTART, metrics=False)
    for f in ("trace", "node_state", "now", "ev_time"):
        np.testing.assert_array_equal(synced[f], verbatim[f], err_msg=f)


def test_durable_sync_requires_durable_cols():
    with pytest.raises(ValueError, match="durable_sync"):
        tcore.Workload(name="bad", n_nodes=1, state_width=2,
                       handlers=(lambda ctx: (ctx.state, ctx.emits().build()),),
                       durable_sync=True)
    _jw, tw = make_probes(sync_call=True)
    with pytest.raises(ValueError, match="make_init\\(metrics=True\\)"):
        tcore.make_run_plain(tw, tcore.EngineConfig(**PROBE_KW), 1, metrics=True)(
            tcore.make_init(tw, tcore.EngineConfig(**PROBE_KW), device="cpu")(SEEDS[:2]))


def test_raftlog_variants_and_their_errors():
    assert trl.make_raftlog(durable=True, bug="nosync").name == "raftlog-nosync"
    assert trl.make_raftlog(durable=True).name == "raftlog"
    assert trl.make_raftlog(durable=True).durable_sync and not trl.make_raftlog().durable_sync
    for fkw in (dict(durable=True), dict(durable=True, record=True, chaos=False),
                dict(durable=True, record=True, chaos=False, bug="nosync")):
        jw, tw = jrl.make_raftlog(**fkw), trl.make_raftlog(**fkw)
        assert (tw.name, tw.durable_cols, tw.durable_sync, tw.history) == (
            jw.name, jw.durable_cols, jw.durable_sync,
            tcore.HistorySpec(**vars(jw.history)) if jw.history else None)
    with pytest.raises(ValueError, match="needs durable=True"):
        trl.make_raftlog(bug="nosync")
    with pytest.raises(ValueError, match="unknown raftlog bug"):
        trl.make_raftlog(durable=True, bug="fsync-maybe")
