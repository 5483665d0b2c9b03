"""``madsim_tpu_torch.farm`` against the JAX package's ``farm``.

* ``EnergySchedule``: the parent pool, its cumulative weights, the picks
  on the farm lane (with their times-picked decay) and the inherit
  thresholds equal the JAX package's on the same corpus; so do
  ``FarmEnergy.pick``'s tenant awards.
* ``explore.run(energy=EnergySchedule())`` on the kvchaos lost-write
  mutant equals the JAX package's campaign (the farm soak's certificate 3
  cut to 2 x 24; the small pin of ``tests/_torch_farm_pins.py``'s form
  re-derived from the JAX package in this run), and energy absent, ``None`` and
  ``mode="uniform"`` are one campaign.
* ``run_pipelined`` equals ``run_device`` — corpus, map, violations,
  curves and the checkpoint file's bytes — with one consume point a
  generation (``host_syncs`` None: not counted here) and the queue/idle split, at depth 2 and 3; a zero-step
  campaign admits nothing, so the breed speculation misses
  and is re-dispatched (``respeculations``), bit-identically; a
  pipelined checkpoint resumes onto the uninterrupted campaign; each
  checkpoint, read from its generation's host copy, is the campaign a
  run without one reports (a corpus at its cap, violations found).
* ``run_farm``: two tenants in one-generation quanta equal their
  standalone campaigns, with tenant-tagged records and one build per
  program key; ``total_generations`` caps the farm; the validation
  errors are the JAX package's.
"""

import _torch_threads  # noqa: F401
import types

import numpy as np
import pytest

import madsim_tpu.chaos as jch
import madsim_tpu.check as jk
import madsim_tpu.explore as jx
import madsim_tpu.farm as jf
import madsim_tpu.models as jm
from madsim_tpu.engine import EngineConfig as JCfg
import madsim_tpu_torch.chaos as tch
import madsim_tpu_torch.check as tk
import madsim_tpu_torch.explore as tx
import madsim_tpu_torch.models as tm
from madsim_tpu_torch import farm
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.explore import device as tdev
from madsim_tpu_torch.explore.persist import load_campaign
from madsim_tpu_torch.obs import prof

from _torch_explore import fingerprint
from _torch_farm_pins import KV_CFG_KW, farm_plan, invariants, kv_hinv, kv_plan

INV = invariants()
CFG_KW = dict(pool_size=64, loss_p=0.02)
KW = dict(generations=3, batch=48, root_seed=7, max_steps=128, cov_words=32,
          invariant=INV["cov"], device="cpu")
WL = tm.make_raft()  # one workload object: the generation cache's identity
CFG = tcore.EngineConfig(**CFG_KW)
PLAN = farm_plan(tch)
KV_SMALL = dict(generations=2, batch=24, max_steps=400, cov_words=64, max_ops=1,
                inherit_seed_p=0.9)


def _corpus(mod):
    """A synthetic corpus: varied scores, verdicts and bitmaps."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(40):
        cov = rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
        cov &= rng.integers(0, 2**32, size=8, dtype=np.uint64).astype(np.uint32)
        out.append(types.SimpleNamespace(id=i, new_bits=int(rng.integers(0, 50)),
                                         violating=bool(rng.random() < 0.3), cov=cov))
    return out


@pytest.mark.parametrize("sched", [
    dict(), dict(top=5), dict(rare_k=4, decay=1, bits_cap=8),
    dict(inherit_seed_p=0.5, inherit_viol_p=0.2),
], ids=["default", "top5", "knobs", "inherit"])
def test_energy_schedule_equals_the_reference(sched):
    corpus = _corpus(None)
    js, ts = jf.EnergySchedule(**sched).state(), farm.EnergySchedule(**sched).state()
    rng = np.random.default_rng(9)
    for _round in range(3):
        jpool, jcum = js.pool(corpus, select_top=12)
        tpool, tcum = ts.pool(corpus, select_top=12)
        assert [e.id for e in tpool] == [e.id for e in jpool]
        np.testing.assert_array_equal(tcum, jcum)
        for k0, k1 in rng.integers(0, 2**32, size=(32, 2), dtype=np.uint64):
            assert ts.choose(int(k0), int(k1), tpool, tcum) == js.choose(
                int(k0), int(k1), jpool, jcum)
        assert ts.picks == js.picks
    for e in corpus[:8]:
        for p in (0.25, 0.75, 0.95):
            assert ts.inherit_threshold(e, p) == js.inherit_threshold(e, p)
    with pytest.raises(ValueError, match="unknown energy mode"):
        farm.EnergySchedule(mode="warp").state()


def test_farm_energy_pick_equals_the_reference():
    names = ["a", "b", "c", "d"]
    for root in (0, 7, 2**40 + 3):
        je_, te = jf.FarmEnergy(root_seed=root), farm.FarmEnergy(root_seed=root)
        for gains in ({}, {"a": (0, 0), "b": (40, 2)}, {n: (i, i % 2) for i, n in
                                                       enumerate(names)}):
            for i in range(64):
                assert te.pick(i, names, gains) == je_.pick(i, names, gains)
    assert not farm.FarmEnergy(mode="uniform").active and farm.FarmEnergy().active


def test_explore_energy_campaign_equals_the_reference():
    """The farm soak's certificate 3 cut to 2 x 24 at root 7: the uniform
    and adaptive campaigns equal the JAX package's, and the small pin
    (violations and bits of each) is re-derived from the JAX package in
    this run."""
    jwl = jm.make_kvchaos(writes=10, record=True, bug=True, chaos=False)
    twl = tm.make_kvchaos(writes=10, record=True, bug=True, chaos=False)
    jcfg, tcfg = JCfg(**KV_CFG_KW), tcore.EngineConfig(**KV_CFG_KW)
    jkw = dict(root_seed=7, history_invariant=kv_hinv(jk), **KV_SMALL)
    tkw = dict(root_seed=7, history_invariant=kv_hinv(tk), device="cpu", **KV_SMALL)
    ju = jx.run(jwl, jcfg, kv_plan(jch), **jkw)
    ja = jx.run(jwl, jcfg, kv_plan(jch), energy=jf.EnergySchedule(), **jkw)
    tu = tx.run(twl, tcfg, kv_plan(tch), **tkw)
    ta = tx.run(twl, tcfg, kv_plan(tch), energy=farm.EnergySchedule(), **tkw)
    assert fingerprint(tu) == fingerprint(ju) and fingerprint(ta) == fingerprint(ja)

    def pin(u, a):
        return (len(u.violations), u.coverage_bits, len(a.violations), a.coverage_bits)

    assert pin(tu, ta) == pin(ju, ja) and ta.violations
    assert fingerprint(ta) != fingerprint(tu)


def test_energy_off_is_the_uniform_campaign():
    """Energy absent, ``None`` and ``mode="uniform"`` are one campaign
    (raft under the farm soak's plan, host driver); the adaptive
    schedule breeds another."""
    kw = dict(KW, invariant=INV["halt"])
    absent = fingerprint(tx.run(WL, CFG, PLAN, **kw))
    for off in (None, farm.EnergySchedule(mode="uniform")):
        assert fingerprint(tx.run(WL, CFG, PLAN, energy=off, **kw)) == absent
    assert fingerprint(tx.run(WL, CFG, PLAN, energy=farm.EnergySchedule(), **kw)) != absent


@pytest.fixture(scope="module")
def blocking(tmp_path_factory):
    path = tmp_path_factory.mktemp("blk") / "c.ckpt"
    records = []
    rep = tx.run_device(WL, CFG, PLAN, checkpoint_path=str(path), telemetry=records.append,
                        **KW)
    return rep, path.read_bytes(), records


@pytest.mark.parametrize("depth", [2, 3])
def test_pipelined_equals_blocking(blocking, depth, tmp_path):
    rep_b, ckpt_b, _recs = blocking
    path, records = tmp_path / "p.ckpt", []
    rep = farm.run_pipelined(WL, CFG, PLAN, depth=depth, checkpoint_path=str(path),
                             telemetry=records.append, **KW)
    assert fingerprint(rep) == fingerprint(rep_b)
    assert path.read_bytes() == ckpt_b
    gens = [r for r in records if r["event"] == "generation"]
    assert len(gens) == KW["generations"] and all(g["host_syncs"] is None for g in gens)
    assert all(g["dispatch_wall_s"] == pytest.approx(g["queue_wall_s"] + g["idle_wall_s"],
                                                     abs=2e-3) for g in gens)
    start, end = records[0], records[-1]
    assert start["driver"] == "device-pipelined" and start["pipeline_depth"] == depth
    assert end["host_syncs"] is None and end["respeculations"] == 0
    assert rep.wall_dispatch_s == pytest.approx(rep.wall_queue_s + rep.wall_idle_s, abs=1e-6)
    assert rep.host_syncs == KW["generations"]
    with pytest.raises(ValueError, match="depth >= 1"):
        farm.run_pipelined(WL, CFG, PLAN, depth=0, **KW)


def test_pipelined_respeculates_when_nothing_is_admitted():
    """A zero-step cap: no seed dispatches an event, so no bitmap has a
    bit and nothing is admitted; each speculated breed generation misses
    and is re-dispatched from its pre-generation carry — bit-identically."""
    kw = dict(KW, generations=4, max_steps=0)
    block = tx.run_device(WL, CFG, PLAN, **kw)
    records = []
    pipe = farm.run_pipelined(WL, CFG, PLAN, telemetry=records.append, **kw)
    assert not block.corpus and fingerprint(pipe) == fingerprint(block)
    assert records[-1]["respeculations"] > 0


def test_pipelined_checkpoint_resume_splice(blocking, tmp_path):
    path = tmp_path / "pipe.ckpt"
    farm.run_pipelined(WL, CFG, PLAN, checkpoint_path=str(path), **dict(KW, generations=2))
    resumed = farm.run_pipelined(WL, CFG, PLAN, resume=str(path), **dict(KW, generations=1))
    assert fingerprint(resumed) == fingerprint(blocking[0])


@pytest.mark.parametrize("driver", ["blocking", "pipelined"])
def test_checkpoint_reads_the_generation_host_copy(driver, tmp_path):
    """Each checkpoint is built from its generation's host copy (the map,
    the stores' counts before it and the rows it may have admitted),
    never from the card: a hunt whose corpus fills its cap saves,
    generation by generation, the campaign that a run without a
    checkpoint reports from the card at its end."""
    kw = dict(KW, invariant=INV["biased"], max_corpus=20, viol_cap=400)
    ref = tx.run_device(WL, CFG, PLAN, **kw)
    assert len(ref.corpus) == 20 and ref.violations
    path = tmp_path / "c.ckpt"
    run = tx.run_device if driver == "blocking" else farm.run_pipelined
    rep = run(WL, CFG, PLAN, checkpoint_path=str(path), **kw)
    assert fingerprint(rep) == fingerprint(ref)
    assert fingerprint(load_campaign(str(path))) == fingerprint(ref)
    short = tmp_path / "short.ckpt"
    run(WL, CFG, PLAN, checkpoint_path=str(short), **dict(kw, generations=2))
    resumed = tx.run_device(WL, CFG, PLAN, resume=str(short), **dict(kw, generations=1))
    assert fingerprint(resumed) == fingerprint(ref)


def _tenant_kwargs():
    return {
        "halt": dict(invariant=INV["halt"], batch=32, root_seed=11, max_steps=64, cov_words=32,
                     device="cpu"),
        "biased": dict(invariant=INV["biased"], batch=48, root_seed=5, max_steps=64,
                       cov_words=32, device="cpu"),
    }


@pytest.mark.parametrize("pipeline", [False, True], ids=["blocking", "pipelined"])
def test_two_tenants_scheduled_equal_standalone(pipeline):
    kws = _tenant_kwargs()
    refs = {n: tx.run_device(WL, CFG, PLAN, generations=3, **k) for n, k in kws.items()}
    tdev._GEN_CACHE.clear()
    records = []
    with prof.profiled() as p:
        rep = farm.run_farm([farm.Tenant(n, WL, CFG, PLAN, generations=3, kwargs=k)
                             for n, k in kws.items()], quantum=1, pipeline=pipeline,
                            telemetry=records.append)
    for n in kws:
        assert fingerprint(rep.reports[n]) == fingerprint(refs[n]), n
    assert rep.slices == 6 and rep.preemptions == {"halt": 2, "biased": 2}
    assert [s[1] for s in rep.schedule] == ["halt", "biased"] * 3
    retr = p.retraces("explore.device")
    assert retr and all(v == 1 for v in retr.values())
    tags = [r["tenant"] for r in records if r["event"] == "generation"]
    assert sorted(tags) == sorted(["halt", "biased"] * 3)
    assert "2 tenants over 6 slices" in rep.banner()


def test_total_generations_and_energy_awards():
    kws = _tenant_kwargs()
    tenants = [farm.Tenant(n, WL, CFG, PLAN, kwargs=k) for n, k in kws.items()]
    rep = farm.run_farm(tenants, quantum=2, total_generations=5)
    assert [(n, g) for _s, n, g in rep.schedule] == [("halt", 2), ("biased", 2), ("halt", 1)]
    energy = farm.FarmEnergy(root_seed=3)
    one = farm.run_farm(tenants, quantum=1, total_generations=4, energy=energy)
    two = farm.run_farm(tenants, quantum=1, total_generations=4, energy=energy)
    assert one.schedule == two.schedule and len(one.schedule) == 4
    # the first award: every tenant at bootstrap weight, the JAX draw
    assert one.schedule[0][1] == jf.FarmEnergy(root_seed=3).pick(0, list(kws), {})


@pytest.mark.parametrize("case", ["empty", "dup", "quantum", "budget", "owned"])
def test_validation_errors_are_the_reference(case):
    def tenants(mod, farm_mod):
        t = lambda n, **kw: farm_mod.Tenant(n, None, None, None, **kw)  # noqa: E731
        return {
            "empty": ([], {}),
            "dup": ([t("a", generations=1), t("a", generations=1)], {}),
            "quantum": ([t("a", generations=1)], {"quantum": 0}),
            "budget": ([t("a")], {}),
            "owned": ([t("a", generations=1, kwargs={"resume": None})], {}),
        }[case]

    jt, jkw = tenants(jm, jf)
    tt, tkw = tenants(tm, farm)
    with pytest.raises(ValueError) as want:
        jf.run_farm(jt, **jkw)
    with pytest.raises(ValueError) as got:
        farm.run_farm(tt, **tkw)
    assert str(got.value) == str(want.value)
