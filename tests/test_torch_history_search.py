"""Seed search over recorded histories, in the torch port against the
JAX package.

``search_seeds(history_invariant=...)``: the kvchaos lost-write mutant
that only the history checkers see (the final-state durability
invariant passes on every seed), raft's election safety over recorded
wins, the quarantine of seeds whose history buffer dropped records, and
the compacted runner (on and off agree, and its banked history columns
equal the JAX package's). Exact equality of verdicts, traces and
history rows.
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest

import madsim_tpu.check as jcheck
import madsim_tpu.engine as je
from madsim_tpu.models import make_kvchaos as j_kv
from madsim_tpu.models import make_raft as j_raft
import madsim_tpu_torch.engine as te
from madsim_tpu_torch import check as tcheck
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import search_seeds
from madsim_tpu_torch.engine.compact import RESULT_FIELDS, make_run_compacted
from madsim_tpu_torch.models import make_kvchaos as t_kv
from madsim_tpu_torch.models import make_raft as t_raft
from madsim_tpu_torch.models.raft import OP_ELECT

W = 5  # kvchaos writes, as in the JAX package's history-search tests
KV_KW = dict(pool_size=192, loss_p=0.05)
KV_SEEDS, KV_CAP = 512, 1500


def durability(v):
    """The final-state invariant for kvchaos at W writes: the client saw
    every commit and the last write sits on at least 3 of 4 replicas."""
    ns = np.asarray(v["node_state"])
    return (ns[:, 5, 0] == W) & ((ns[:, 1:5, 0] >= W).sum(axis=1) >= 3)


def _search(mod, engine, wl, kw, n, cap, inv, hinv, **opts):
    """One search in either package; returns (report, the final-state
    verdicts, the BatchHistory the history invariant saw)."""
    box = {}

    def probe(view):
        box["final"] = np.asarray(inv(view), bool)
        return np.ones_like(box["final"])

    def hprobe(h):
        box["h"] = h
        return hinv(mod, h)

    rep = engine.search_seeds(wl, engine.EngineConfig(**kw), probe, n_seeds=n,
                              max_steps=cap, history_invariant=hprobe, **opts)
    return rep, box["final"], box["h"]


def lost_write(mod, h):
    return mod.stale_reads(h) & mod.read_your_writes(h)


def _same_report(t, j):
    for attr in ("seeds", "ok", "halted", "overflowed", "failing_seeds", "pool_overflowed",
                 "hist_dropped", "halt_times"):
        np.testing.assert_array_equal(np.asarray(getattr(t, attr)), np.asarray(getattr(j, attr)),
                                      err_msg=attr)
    np.testing.assert_array_equal(t.traces, np.asarray(j.traces))
    assert t.banner() == j.banner()


@pytest.fixture(scope="module")
def kv_bug_reports():
    jr = _search(jcheck, je, j_kv(writes=W, record=True, bug=True), KV_KW, KV_SEEDS, KV_CAP,
                 durability, lost_write)
    tr = _search(tcheck, te,
                 t_kv(writes=W, record=True, bug=True), KV_KW, KV_SEEDS, KV_CAP,
                 durability, lost_write, device="cpu")
    return jr, tr


def test_lost_write_mutant_found_by_history_only(kv_bug_reports):
    """The JAX package's flagship check: the mutant's halt states pass
    the durability invariant on every seed, and the history checkers
    flag the same seeds in both packages."""
    (jrep, _jfinal, _jh), (trep, tfinal, th) = kv_bug_reports
    assert trep.failing_seeds.size > 0
    assert tfinal.all()
    _same_report(trep, jrep)
    # the exact checker agrees with the vectorized detector
    for s in trep.failing_seeds[:2]:
        assert not tcheck.check_kv(th.ops(int(np.searchsorted(trep.seeds, s)))).ok


def test_compacted_search_agrees(kv_bug_reports):
    _j, (trep, _f, _h) = kv_bug_reports
    fast, _final, h = _search(tcheck, te,
                              t_kv(writes=W, record=True, bug=True), KV_KW, KV_SEEDS,
                              KV_CAP, durability, lost_write, device="cpu", compact=True)
    for attr in ("ok", "halted", "traces", "failing_seeds", "hist_dropped"):
        np.testing.assert_array_equal(getattr(fast, attr), getattr(trep, attr), err_msg=attr)
    assert h.word.shape == (KV_SEEDS, 4 * W, 5)


def test_raft_election_safety_matches_reference():
    kw = dict(pool_size=48, loss_p=0.02)

    def has_leader(v):
        return (np.asarray(v["node_state"])[:, :, 0] == 2).any(axis=1)

    def safe(mod, h):
        return mod.election_safety(h, elect_op=OP_ELECT)

    jrep, _jf, _jh = _search(jcheck, je, j_raft(record=True), kw, 128, 600, has_leader, safe)
    trep, tfinal, th = _search(tcheck, te,
                               t_raft(record=True), kw, 128, 600, has_leader, safe,
                               device="cpu")
    _same_report(trep, jrep)
    assert trep.failing_seeds.size == 0 and tfinal.all() and trep.halted.all()
    assert (th.count >= 1).all() and (th.drop == 0).all()
    v = th.valid()
    assert (th.col(tcheck.COL_OP)[v] == OP_ELECT).all()
    assert ((th.col(tcheck.COL_ARG)[v] >= 0) & (th.col(tcheck.COL_ARG)[v] < 5)).all()


def test_dropped_records_quarantine_the_seed():
    """At capacity 6 every seed drops records: each reaches a strict
    per-seed checker as an empty history, and the report excludes it as
    the JAX package's does."""
    def strict(mod, h):
        for i in range(h.count.shape[0]):
            h.ops(i)  # strict: raises on a seed that dropped records
        return np.ones(h.count.shape[0], bool)

    def ok(v):
        return np.ones(len(v["seed"]), bool)

    kw = dict(hist_capacity=6, writes=W, record=True, bug=True)
    jrep, _jf, _jh = _search(jcheck, je, j_kv(**kw), KV_KW, 32, KV_CAP, ok, strict)
    trep, _tf, th = _search(tcheck, te,
                            t_kv(**kw), KV_KW, 32, KV_CAP, ok, strict, device="cpu")
    _same_report(trep, jrep)
    assert trep.hist_dropped.all() and not trep.pool_overflowed.any()
    assert trep.failing_seeds.size == 0 and trep.overflowed_seeds.size == 32
    assert (th.count == 0).all() and (th.drop == 0).all()
    assert "history 32" in trep.banner()


def test_history_invariant_arguments_are_validated():
    cfg = tcore.EngineConfig(**KV_KW)
    with pytest.raises(ValueError, match="Workload.history=None"):
        search_seeds(t_kv(writes=W), cfg, None, n_seeds=4, max_steps=10, device="cpu",
                     history_invariant=lambda h: np.ones(4, bool))
    with pytest.raises(ValueError, match="need an invariant, a history_invariant or a device_check"):
        search_seeds(t_kv(writes=W, record=True), cfg, None, n_seeds=4, max_steps=10,
                     device="cpu")


def test_compacted_record_run_banks_the_reference_history():
    """make_run_compacted over kvchaos-record in several phases: every
    banked field, the four history columns included, equals the JAX
    package's compacted runner."""
    seeds = np.arange(64, dtype=np.uint64) * np.uint64(131)
    kw = dict(pool_size=40, loss_p=0.02)
    jwl, twl = j_kv(writes=W, record=True), t_kv(writes=W, record=True)
    jcfg, tcfg = je.EngineConfig(**kw), tcore.EngineConfig(**kw)
    jout = je.make_run_compacted(jwl, jcfg, 900, shrink=2, min_size=8)(
        je.make_init(jwl, jcfg, time32=False)(seeds))
    tout = make_run_compacted(twl, tcfg, 900, shrink=2, min_size=8)(
        tcore.make_init(twl, tcfg, device="cpu")(seeds))
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(tout, f), np.asarray(getattr(jout, f)), err_msg=f)
    assert tout.hist_count.min() > 0
