"""``obs.telemetry`` of the port against the JAX package's: the
``explain`` and ``explain_diff`` narratives are the same text, character
for character, for the same arguments — raft-record under a pause storm
with its election-safety history check, kvchaos-bug with its own chaos
judged by its read checkers (and the ``explain_diff`` of
a clean and a violating seed), the causal cone (``causal=True``, both
narratives) and the latency section of the latency soak's army
(``latency=``). Every capture runs the port's plain step on the CPU.
``JsonlSink`` flushes every record and fsyncs on request; all eleven
model families name their handlers as the JAX package does, army
handlers included.
"""

import _torch_threads  # noqa: F401
import json
import os

import numpy as np
import pytest

import madsim_tpu.chaos as jch
import madsim_tpu.check as jk
import madsim_tpu.engine as je
import madsim_tpu.models as jm
import madsim_tpu.obs as jo
import madsim_tpu_torch.chaos as tch
import madsim_tpu_torch.check as tk
import madsim_tpu_torch.models as tm
import madsim_tpu_torch.obs as to
from madsim_tpu_torch.engine import core as tcore

from _torch_explore import raft_plan

RAFT_KW = dict(pool_size=64, loss_p=0.02)
# the screen-search shape (tests/test_torch_screen_search.py): some of
# seeds 0..59 violate, some stop at the cap
KV_KW = dict(pool_size=40, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
KV_STEPS = 600
LAT_SOAK = dict(writes=20, n_replicas=2, chaos=False, army=True, army_probes=3)
LAT_ARMY = dict(n_ops=64, t_min_ns=5_000_000, t_max_ns=500_000_000, n_replicas=2)
LAT_SPEC = dict(ops=64, phases=2, phase_ns=1 << 28)
LAT_KW = dict(pool_size=160, time_limit_ns=700_000_000)


def both(name, jargs, targs, **kw):
    """The same narrative from both packages (``name``: explain or
    explain_diff); asserts equality and returns the text."""
    want = getattr(jo, name)(*jargs, **kw)
    got = getattr(to, name)(*targs, device="cpu", **kw)
    assert got == want
    return got


def kv_hinv(k):
    return lambda h: k.stale_reads(h) & k.read_your_writes(h) & k.monotonic_reads(h)


def raft_hinv(k, m):
    return lambda h: k.election_safety(h, elect_op=m.raft.OP_ELECT)


@pytest.fixture(scope="module")
def kv():
    """kvchaos-bug with its own chaos: both packages' workloads and a
    clean and a violating seed of the port's search (the same seeds the
    JAX package's search finds: the engines are held equal elsewhere)."""
    jwl = jm.make_kvchaos(writes=5, record=True, bug=True)
    twl = tm.make_kvchaos(writes=5, record=True, bug=True)
    rep = tcore_search(twl)
    bad = [int(s) for s in rep.failing_seeds]
    good = [int(s) for s in rep.seeds if int(s) not in bad]
    assert bad and good
    return jwl, twl, good[0], bad[0]


def tcore_search(twl):
    from madsim_tpu_torch.engine.search import search_seeds

    return search_seeds(twl, tcore.EngineConfig(**KV_KW), None, n_seeds=60,
                        max_steps=KV_STEPS, history_invariant=kv_hinv(tk), device="cpu")


def test_explain_raft_record_under_a_plan():
    seed = 3
    jwl, twl = jm.make_raft(record=True), tm.make_raft(record=True)
    text = both("explain",
                (jwl, je.EngineConfig(**RAFT_KW), seed, raft_plan(jch)),
                (twl, tcore.EngineConfig(**RAFT_KW), seed, raft_plan(tch)),
                history_invariant=None, max_steps=600, timeline_cap=256, max_events=30)
    assert "--- injected fault plan:" in text and "timeout(" in text
    jtext = jo.explain(jwl, je.EngineConfig(**RAFT_KW), seed, raft_plan(jch),
                       history_invariant=raft_hinv(jk, jm), max_steps=600, timeline_cap=256)
    ttext = to.explain(twl, tcore.EngineConfig(**RAFT_KW), seed, raft_plan(tch),
                       history_invariant=raft_hinv(tk, tm), max_steps=600, timeline_cap=256,
                       device="cpu")
    assert ttext == jtext and "--- verdict: history invariant HOLDS" in ttext


def test_explain_and_diff_kvchaos_bug_with_its_chaos(kv):
    jwl, twl, good, bad = kv
    jcfg, tcfg = je.EngineConfig(**KV_KW), tcore.EngineConfig(**KV_KW)
    text = both("explain", (jwl, jcfg, bad), (twl, tcfg, bad),
                history_invariant=None, max_steps=KV_STEPS,
                timeline_cap=512, max_events=60)
    assert "narrative only" in text
    jt = jo.explain(jwl, jcfg, bad, history_invariant=kv_hinv(jk), max_steps=KV_STEPS,
                    timeline_cap=512, max_events=60)
    tt = to.explain(twl, tcfg, bad, history_invariant=kv_hinv(tk), max_steps=KV_STEPS,
                    timeline_cap=512, max_events=60, device="cpu")
    assert tt == jt and "history invariant VIOLATED" in tt and "rows elided" in tt
    jd = jo.explain_diff(jwl, jcfg, (good, None), (bad, None),
                         history_invariant=kv_hinv(jk), max_steps=KV_STEPS, timeline_cap=512)
    td = to.explain_diff(twl, tcfg, (good, None), (bad, None),
                         history_invariant=kv_hinv(tk), max_steps=KV_STEPS, timeline_cap=512,
                         device="cpu")
    assert td == jd and "first divergent timeline row" in td


def test_explain_causal_cone_and_edge(kv):
    jwl, twl, good, bad = kv
    jcfg, tcfg = je.EngineConfig(**KV_KW), tcore.EngineConfig(**KV_KW)
    jt = jo.explain(jwl, jcfg, bad, history_invariant=kv_hinv(jk), max_steps=KV_STEPS,
                    timeline_cap=512, max_events=40, causal=True)
    tt = to.explain(twl, tcfg, bad, history_invariant=kv_hinv(tk), max_steps=KV_STEPS,
                    timeline_cap=512, max_events=40, causal=True, device="cpu")
    assert tt == jt and "--- causal anchor:" in tt and "causal cone:" in tt
    jd = jo.explain_diff(jwl, jcfg, (good, None), (bad, None), max_steps=KV_STEPS,
                         timeline_cap=512, causal=True)
    td = to.explain_diff(twl, tcfg, (good, None), (bad, None), max_steps=KV_STEPS,
                         timeline_cap=512, causal=True, device="cpu")
    assert td == jd and "causal edge" in td


def test_explain_latency_section():
    seed = 6151
    jplan = jch.FaultPlan((jm.kvchaos.client_army(**LAT_ARMY),), name="army")
    tplan = tch.FaultPlan((tm.kvchaos.client_army(**LAT_ARMY),), name="army")
    text = both("explain",
                (jm.make_kvchaos(**LAT_SOAK), je.EngineConfig(**LAT_KW), seed, jplan),
                (tm.make_kvchaos(**LAT_SOAK), tcore.EngineConfig(**LAT_KW), seed, tplan),
                max_steps=3000, timeline_cap=64, max_events=20)
    assert "--- latency" not in text
    jt = jo.explain(jm.make_kvchaos(**LAT_SOAK), je.EngineConfig(**LAT_KW), seed, jplan,
                    max_steps=3000, timeline_cap=64, max_events=20,
                    latency=je.LatencySpec(**LAT_SPEC))
    tt = to.explain(tm.make_kvchaos(**LAT_SOAK), tcore.EngineConfig(**LAT_KW), seed, tplan,
                    max_steps=3000, timeline_cap=64, max_events=20,
                    latency=tcore.LatencySpec(**LAT_SPEC), device="cpu")
    assert tt == jt and "--- latency:" in tt and "slowest completed:" in tt


def test_jsonl_sink_flushes_every_record_and_fsyncs(tmp_path, monkeypatch):
    path = tmp_path / "t.jsonl"
    synced = []
    monkeypatch.setattr(os, "fsync", lambda fd: synced.append(fd))
    with to.JsonlSink(str(path), fsync=True) as sink:
        sink({"event": "generation", "b": 1, "a": [1, 2]})
        # flushed before the next record: a reader sees it now
        assert json.loads(path.read_text()) == {"a": [1, 2], "b": 1, "event": "generation"}
        sink({"event": "campaign_end"})
    assert len(synced) == 2
    lines = path.read_text().splitlines()
    assert lines[0] == json.dumps({"event": "generation", "b": 1, "a": [1, 2]}, sort_keys=True)
    # an open file is written, not closed; fsync off writes no sync
    with open(tmp_path / "u.jsonl", "w") as fh:
        sink = to.JsonlSink(fh)
        sink({"x": 1})
        sink.close()
        assert not fh.closed
    assert len(synced) == 2
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "tt.jsonl"
    recs = [{"event": "heartbeat", "eta_s": None, "z": 1.5}, {"event": "x", "tenant": "a"}]
    with jo.JsonlSink(str(jpath)) as js, to.JsonlSink(str(tpath)) as ts:
        for r in recs:
            js(r)
            ts(r)
    assert tpath.read_bytes() == jpath.read_bytes()


FACTORIES = [
    ("make_raft", {}), ("make_raft", {"record": True}), ("make_microbench", {}),
    ("make_pingpong", {}), ("make_broadcast", {}), ("make_kvchaos", {}),
    ("make_kvchaos", {"army": True}), ("make_raftlog", {}), ("make_raftlog", {"army": True}),
    ("make_snapshot", {}), ("make_twophase", {}), ("make_paxos", {}), ("make_leasekv", {}),
    ("make_leasekv", {"army": True}), ("make_shardkv", {}), ("make_shardkv", {"army": True}),
]


@pytest.mark.parametrize("factory,kw", FACTORIES,
                         ids=[f"{f}{'-' + '-'.join(kw) if kw else ''}" for f, kw in FACTORIES])
def test_handler_names_are_the_jax_packages(factory, kw):
    jwl, twl = getattr(jm, factory)(**kw), getattr(tm, factory)(**kw)
    assert twl.handler_names == jwl.handler_names
    assert len(twl.handler_names) == len(twl.handlers)
