"""The kvchaos lost-write mutant through the port's host campaign,
against the JAX package's (``tests/test_explore.py``'s
``TestCampaignFindsViolations``, at 2 generations of 24): the port's
campaign equals the JAX package's, its first violation replays to its
trace, and ``chaos.shrink_plan`` gives the JAX package's events, rounds,
probes and trace. Every value is an integer or a hash: equality is
exact. (Its own file: the plain step on the CPU takes most of a minute
for the campaign and the shrink.)
"""

import _torch_threads  # noqa: F401
import dataclasses

from _torch_explore import fingerprint, kv_plan

import madsim_tpu.chaos as jch
import madsim_tpu.explore as jx
from madsim_tpu.check import read_your_writes as j_ryw
from madsim_tpu.check import stale_reads as j_stale
from madsim_tpu.engine import EngineConfig as JCfg
from madsim_tpu.models import make_kvchaos as j_kv
import madsim_tpu_torch.chaos as tch
import madsim_tpu_torch.explore as tx
from madsim_tpu_torch.check import read_your_writes as t_ryw
from madsim_tpu_torch.check import stale_reads as t_stale
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.models import make_kvchaos as t_kv


def test_kvchaos_mutant_found_replayed_and_shrunk():
    """The lost-write mutant: the port's tiny campaign finds the JAX
    package's violations; the first replays to its trace and shrinks to
    the JAX package's events and trace."""
    box = {}

    def j_hinv(h):
        return j_stale(h) & j_ryw(h)

    def t_hinv(h):
        box["ok"] = t_stale(h) & t_ryw(h)
        return box["ok"]

    kw = dict(generations=2, batch=24, root_seed=3, max_steps=3000, cov_words=16)
    cfg = dict(pool_size=160, loss_p=0.05)
    want = jx.run(j_kv(writes=6, record=True, bug=True, chaos=False), JCfg(**cfg),
                  kv_plan(jch), history_invariant=j_hinv, **kw)
    wl, tcfg = t_kv(writes=6, record=True, bug=True, chaos=False), tcore.EngineConfig(**cfg)
    rep = tx.run(wl, tcfg, kv_plan(tch), history_invariant=t_hinv, device="cpu", **kw)
    assert fingerprint(rep) == fingerprint(want)
    assert rep.violations, "mutant not caught by the campaign"
    e = rep.violations[0]
    r = tx.replay_entry(wl, tcfg, e, history_invariant=t_hinv, max_steps=3000, device="cpu")
    assert int(r.traces[0]) == e.trace and not bool(r.ok[0])
    res = tch.shrink_plan(wl, tcfg, e.seed, e.plan, history_invariant=t_hinv,
                          max_steps=3000, device="cpu")
    jres = jch.shrink_plan(j_kv(writes=6, record=True, bug=True, chaos=False), JCfg(**cfg),
                           e.seed, want.violations[0].plan, history_invariant=j_hinv,
                           max_steps=3000)
    assert [dataclasses.astuple(x) for x in res.events] == [
        dataclasses.astuple(x) for x in jres.events]
    assert res.trace == jres.trace
    assert (res.rounds, res.tested) == (jres.rounds, jres.tested)
