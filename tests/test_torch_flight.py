"""``obs.prof`` and ``obs.flight`` of the port against the JAX package's,
on the flight soak's raft campaign cut to CPU size (pool 64, batches of
64, 96 steps, 32 coverage words; the halt-invariant hunt at a 32-step
cap, so that some seeds violate).

* The profiler: three ``run_device`` campaigns of one shape with three
  root seeds build each generation program once (``retraces == 1`` per
  key), and campaigns 2-3 report ``compile_wall_s == 0``; the search
  program cache counts its builds too.
* The recorder on and off gives the same corpus, map, violations and
  curves on both drivers; the flight log carries the wall-split schema,
  ``host_syncs: None`` per device generation (not counted off the
  card), monotone ``seq`` and
  heartbeats.
* The record keys per event equal the JAX package's (the port's device
  generation records add ``parts_ms``; a compile record carries the
  JAX package's build fields, its cost fields are the backend's).
* ``campaign_perfetto`` of one record list (and of a JSONL log with a
  torn last line) equals the JAX package's document.
* ``tools/campaign_top.py`` renders the port's tenant-tagged farm log.
"""

import _torch_threads  # noqa: F401
import json
import subprocess
import sys
from pathlib import Path

import pytest

import madsim_tpu.chaos as jch
import madsim_tpu.explore as jx
import madsim_tpu.obs as jo
from madsim_tpu.engine import EngineConfig as JCfg
from madsim_tpu.models import make_raft as j_raft
import madsim_tpu_torch.chaos as tch
import madsim_tpu_torch.explore as tx
import madsim_tpu_torch.obs as to
from madsim_tpu_torch import farm
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.explore import device as tdev
from madsim_tpu_torch.models import make_raft as t_raft
from madsim_tpu_torch.obs import prof

from _torch_explore import fingerprint
from _torch_farm_pins import invariants
from _torch_obs_pins import flight_plan

ROOT = Path(__file__).resolve().parent.parent
CFG_KW = dict(pool_size=64, loss_p=0.02)
KW = dict(generations=3, batch=64, max_steps=96, cov_words=32)
# the halt-invariant hunt: a cap short enough for unhalted seeds (finds)
HUNT = dict(KW, max_steps=32, root_seed=7, invariant=invariants()["halt"])
INV = invariants()
WL = t_raft()  # one workload object: the generation cache's identity
CFG = tcore.EngineConfig(**CFG_KW)
PLAN = flight_plan(tch)

DEVICE_WALL_KEYS = ("dispatch_wall_s", "compile_wall_s", "sync_wall_s")
HOST_WALL_KEYS = ("dispatch_wall_s", "compile_wall_s", "mutate_wall_s", "admit_wall_s",
                  "host_wall_s")
# the build fields every compile record carries in both packages
COMPILE_KEYS = {"event", "program", "key", "retrace", "trace_s", "lower_s", "compile_s",
                "seq", "t_s"}


def _tdev(**kw):
    return tx.run_device(WL, CFG, PLAN, device="cpu", **dict(KW, **kw))


def _recorded(run, path):
    with run[1](str(path), heartbeat_s=0.0) as fr:
        rep = run[0](telemetry=fr)
    return rep, [json.loads(line) for line in open(path)]


def test_profiler_builds_each_generation_program_once():
    tdev._GEN_CACHE.clear()
    walls = []
    with prof.profiled() as p:
        for root in (7, 8, 9):
            rep = _tdev(root_seed=root, invariant=INV["cov"])
            walls.append(rep.wall_compile_s)
        retr = p.retraces("explore.device")
        table = p.report()
    assert retr and all(v == 1 for v in retr.values()), retr
    assert {k[0] for k in retr} == {"explore.device.uniform", "explore.device.breed"}
    assert walls[1] == walls[2] == 0.0
    assert "explore.device.breed" in table
    rec = p.programs[next(iter(retr))]
    assert rec.calls >= 3 and set(rec.to_dict()) == set(
        jo.prof.ProgramRecord("a", "b").to_dict())
    # the search program cache is an AotProgram too: built once per key
    with prof.profiled() as p:
        for _ in range(2):
            tx.run(WL, CFG, PLAN, device="cpu", root_seed=5, invariant=INV["cov"],
                   **dict(KW, generations=2))
    runs = p.retraces("engine.search")
    assert runs and all(v == 1 for v in runs.values())
    assert prof.current() is None


@pytest.mark.parametrize("driver", ["device", "host"])
def test_recorder_on_off_identity_and_schema(driver, tmp_path):
    run = tx.run_device if driver == "device" else tx.run
    kw = HUNT
    off = run(WL, CFG, PLAN, device="cpu", **kw)
    on, recs = _recorded((lambda telemetry: run(WL, CFG, PLAN, device="cpu",
                                                telemetry=telemetry, **kw),
                          to.FlightRecorder), tmp_path / f"{driver}.jsonl")
    assert fingerprint(on) == fingerprint(off) and off.violations
    gens = [r for r in recs if r["event"] == "generation"]
    want = DEVICE_WALL_KEYS if driver == "device" else HOST_WALL_KEYS
    assert len(gens) == KW["generations"] and all(all(k in g for k in want) for g in gens)
    if driver == "device":
        assert all(g["host_syncs"] is None for g in gens)  # not counted here
    hbs = [r for r in recs if r["event"] == "heartbeat"]
    assert [r["seq"] for r in recs] == list(range(len(recs)))
    assert [h["generations_done"] for h in hbs] == list(range(1, len(gens) + 1))
    assert recs[-1]["event"] == "flight_summary" and "gen_cache" in recs[-1]


def _keys(recs):
    out: dict = {}
    for r in recs:
        out.setdefault(r["event"], set()).update(r)
    return out


@pytest.mark.parametrize("driver", ["device", "host"])
def test_record_keys_per_event_equal_the_reference(driver, tmp_path):
    from madsim_tpu_torch.engine import search as tsearch

    kw = HUNT
    # cold program caches in both packages: both logs carry compile records
    tsearch._RUN_CACHE.clear()
    tdev._GEN_CACHE.clear()
    jrun = jx.run_device if driver == "device" else jx.run
    trun = tx.run_device if driver == "device" else tx.run
    jwl = j_raft()
    _j, jrecs = _recorded((lambda telemetry: jrun(jwl, JCfg(**CFG_KW), flight_plan(jch),
                                                  telemetry=telemetry, **kw),
                           jo.FlightRecorder), tmp_path / "j.jsonl")
    _t, trecs = _recorded((lambda telemetry: trun(t_raft(), CFG, PLAN, device="cpu",
                                                  telemetry=telemetry, **kw),
                           to.FlightRecorder), tmp_path / "t.jsonl")
    jk, tk = _keys(jrecs), _keys(trecs)
    assert set(tk) == set(jk)
    for ev in tk:
        if ev == "compile":
            assert COMPILE_KEYS <= tk[ev] and COMPILE_KEYS <= jk[ev]
        elif ev == "generation" and driver == "device":
            assert tk[ev] == jk[ev] | {"parts_ms"}
        else:
            assert tk[ev] == jk[ev], ev
    assert [r["event"] for r in trecs if r["event"] != "compile"] == [
        r["event"] for r in jrecs if r["event"] != "compile"]


def test_campaign_perfetto_equals_the_reference(tmp_path):
    path = tmp_path / "hunt.jsonl"
    tdev._GEN_CACHE.clear()  # a cold campaign: real compile records
    rep, recs = _recorded((lambda telemetry: tx.run_device(
        WL, CFG, PLAN, device="cpu", telemetry=telemetry, **HUNT), to.FlightRecorder), path)
    doc = to.campaign_perfetto(recs)
    assert json.dumps(doc, sort_keys=True) == json.dumps(jo.campaign_perfetto(recs),
                                                         sort_keys=True)
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "generation"]
    cov = [e["args"]["cov_bits"] for e in doc["traceEvents"]
           if e.get("ph") == "C" and e.get("name") == "cov_bits"]
    assert len(spans) == KW["generations"] and rep.violations and cov == sorted(cov)
    assert any(e.get("cat") == "compile" for e in doc["traceEvents"])
    # a torn last line: everything before it is still the log
    with open(path, "a") as fh:
        fh.write('{"event": "generation", "gen')
    out = tmp_path / "trace.json"
    got = to.write_campaign_perfetto(str(out), str(path), name="raft")
    assert got == jo.campaign_perfetto(str(path), name="raft")
    assert json.loads(out.read_text())["otherData"]["generations"] == KW["generations"]


def test_campaign_top_renders_the_tagged_farm_log(tmp_path):
    path = tmp_path / "farm.jsonl"
    tenants = [farm.Tenant(n, WL, CFG, PLAN, generations=2,
                           kwargs=dict(KW, generations=None, root_seed=r, invariant=INV["halt"],
                                       device="cpu"))
               for n, r in (("alpha", 3), ("beta", 4))]
    for t in tenants:
        del t.kwargs["generations"]
    with to.FlightRecorder(str(path), heartbeat_s=0.0) as fr:
        rep = farm.run_farm(tenants, quantum=1, telemetry=fr)
    assert rep.slices == 4 and set(rep.reports) == {"alpha", "beta"}
    out = subprocess.run([sys.executable, "tools/campaign_top.py", str(path), "--once"],
                         cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "alpha" in out.stdout and "beta" in out.stdout
