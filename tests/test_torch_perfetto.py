"""The port's Perfetto export (``obs.to_perfetto``) against the JAX
package's: the document of a port capture equals the JAX package's
document of the JAX capture of the same run, as JSON, for a causal ring
(exact arrows, by parent seq) and for the same ring stripped of
``seq``, ``parent`` and ``emit_ns`` (the heuristic arrows); the
same-timestamp fixture shows the heuristic mis-attributing the arrow
the causal path gets right. Exact equality. Both documents are built
with each package's workload, so the user kinds carry the workloads'
``handler_names``: the documents are equal whole, names included."""

import _torch_threads  # noqa: F401
import dataclasses
import json

import numpy as np
import pytest

import madsim_tpu.chaos as jc
import madsim_tpu.models as jm
import madsim_tpu.obs as jobs
from madsim_tpu.engine.replay import ReplayEvent as JEvent
from madsim_tpu_torch import chaos as tc
from madsim_tpu_torch import models as tm
from madsim_tpu_torch import obs as tobs
from madsim_tpu_torch.engine.core import FIRST_USER_KIND
from madsim_tpu_torch.engine.replay import ReplayEvent

from _torch_causal import KV_KW, arrow_plan, capture_both, seeds_of

STRIP = dict(seq=-1, parent=-1, emit_ns=-1)


def arrow_starts(doc) -> dict:
    """Multiset of flow-arrow start anchors (pid, ts)."""
    out: dict = {}
    for row in doc["traceEvents"]:
        if row.get("cat") == "flow" and row.get("ph") == "s":
            out[row["pid"], row["ts"]] = out.get((row["pid"], row["ts"]), 0) + 1
    return out


@pytest.fixture(scope="module")
def captures():
    """kvchaos-bug under the causal soak's arrow confuser, seeds 77-78,
    a 512-row causal ring: both packages' decoded rows per seed."""
    mk = dict(writes=10, record=True, bug=True, chaos=False)
    jwl, twl = jm.make_kvchaos(**mk), tm.make_kvchaos(**mk)
    seeds = seeds_of(2) + np.uint64(77)
    jo, to = capture_both(jwl, twl, arrow_plan(jc), arrow_plan(tc), KV_KW, seeds, 4000,
                          metrics=True, timeline_cap=512, causal=True)
    return [(jwl, jobs.decode_timeline(jo, jwl, s), twl, tobs.decode_timeline(to, twl, s),
             int(seeds[s])) for s in range(len(seeds))]


@pytest.mark.parametrize("stripped", [False, True], ids=["causal", "stripped"])
def test_documents_equal_the_reference(captures, stripped):
    for jwl, jev, twl, tev, seed in captures:
        if stripped:
            jev = [dataclasses.replace(e, **STRIP) for e in jev]
            tev = [dataclasses.replace(e, **STRIP) for e in tev]
        got = tobs.to_perfetto(tev, twl, seed=seed)
        want = jobs.to_perfetto(jev, jwl, seed=seed)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
        rows = [r for r in got["traceEvents"] if r.get("cat") == "dispatch"]
        assert len(rows) == len(tev)


def test_exact_arrows_match_the_parent_column_and_beat_the_heuristic(captures):
    diff = 0
    for _jwl, _jev, twl, ev, seed in captures:
        exact = arrow_starts(tobs.to_perfetto(ev, twl, seed=seed))
        heur = arrow_starts(tobs.to_perfetto([dataclasses.replace(e, **STRIP) for e in ev],
                                             twl, seed=seed))
        diff += sum(abs(exact.get(k, 0) - heur.get(k, 0)) for k in set(exact) | set(heur))
        by_seq = {e.seq: e for e in ev}
        for e in ev:
            if e.src >= 0 and e.parent in by_seq:
                p = by_seq[e.parent]
                assert (p.node, (e.emit_ns if e.emit_ns >= 0 else p.time_ns) / 1e3) in exact
    assert diff > 0


def test_write_perfetto_writes_the_document(captures, tmp_path):
    _jwl, _jev, twl, ev, seed = captures[0]
    path = tmp_path / "trace.json"
    doc = tobs.write_perfetto(str(path), ev, twl, seed=seed)
    assert json.loads(path.read_text()) == json.loads(json.dumps(doc))
    assert doc["otherData"] == {"workload": twl.name, "events": len(ev), "seed": seed}


# the same-timestamp fixture: node 1 emits at t=100 us, then dispatches
# again at the delivery's timestamp; the sender's-last-dispatch heuristic
# anchors the arrow at that decoy, the causal parent at the true emitter

def _fixture(cls=ReplayEvent):
    k = FIRST_USER_KIND
    return [
        cls(time_ns=100_000, kind=k, node=1, src=-1, args=(0, 0, 0, 0), pay=(), seq=0,
            parent=-1, lam=1),
        cls(time_ns=200_000, kind=k, node=1, src=-1, args=(0, 0, 0, 0), pay=(), seq=1,
            parent=-1, lam=2),
        cls(time_ns=200_000, kind=k, node=2, src=1, args=(0, 0, 0, 0), pay=(), seq=2,
            parent=0, lam=2),
    ]


def _starts(doc):
    return [r for r in doc["traceEvents"] if r.get("cat") == "flow" and r["ph"] == "s"]


@pytest.mark.parametrize("form,ts", [
    ("causal", 100.0), ("heuristic", 200.0), ("emit-sidecar", 100.0)])
def test_the_same_timestamp_fixture(form, ts):
    """Causal rows attribute the arrow to the true emitter; stripped rows
    fall back to the decoy; rows with only the emit-time sidecar anchor at
    the true send time. Each document is the JAX package's."""
    def shape(events):
        if form == "heuristic":
            return [dataclasses.replace(e, seq=-1, parent=-1, lam=0) for e in events]
        if form == "emit-sidecar":
            return [dataclasses.replace(e, seq=-1, parent=-1, lam=0,
                                        emit_ns=100_000 if e.src >= 0 else -1)
                    for e in events]
        return events

    doc = tobs.to_perfetto(shape(_fixture()))
    assert doc == jobs.to_perfetto(shape(_fixture(JEvent)))
    (s,) = _starts(doc)
    assert (s["ts"], s["pid"]) == (ts, 1)
    rows = [r for r in doc["traceEvents"] if r.get("cat") == "dispatch"]
    assert len(rows) == 3
    if form == "causal":
        assert [r["args"]["seq"] for r in rows] == [0, 1, 2] and rows[2]["args"]["parent"] == 0
    else:
        assert all("seq" not in r["args"] for r in rows)
