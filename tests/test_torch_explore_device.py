"""``explore.run_device`` of the port — the device-resident campaign is a
lowering of the host driver, not a fork — against the JAX package's
``explore.run``.

``tests/test_explore_device.py``'s cases, case for case, on raft at
pool 64 (3 generations of 24, 600 steps, ``cov_words=16``): the device
campaign's corpus (ids, generations, parents, seeds, plan names and
hashes, traces, new bits, verdicts, halt clocks), coverage map,
violations and both curves equal the host driver's and the JAX
package's, the seed corpus included; violations dedup and replay;
checkpoints resume host to device and device to host, and across the
two packages in both directions; telemetry shows one host sync a
generation; a traceable invariant is required and the violation
store's overflow raises; ``mesh=`` checks the split and runs a world of
one rank as the unsharded campaign. A kvchaos
history hunt judged by the device screens equals the JAX package's
host campaign under the screens' host checkers. Every value is an
integer or a hash: equality is exact.
"""

import _torch_threads  # noqa: F401
import json

import pytest
from _torch_explore import biased_inv, fingerprint, halt_inv, kv_plan, raft_plan

import madsim_tpu.chaos as jch
import madsim_tpu.explore as jx
from madsim_tpu.check import read_your_writes as j_ryw
from madsim_tpu.check import stale_reads as j_stale
from madsim_tpu.engine import EngineConfig as JCfg
from madsim_tpu.models import make_kvchaos as j_kv
from madsim_tpu.models import make_raft as j_raft
import madsim_tpu_torch.chaos as tch
import madsim_tpu_torch.explore as tx
from madsim_tpu_torch.check import device as tdc
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.explore import device as tdev
from madsim_tpu_torch.models import make_kvchaos as t_kv
from madsim_tpu_torch.models import make_raft as t_raft

CFG_KW = dict(pool_size=64, loss_p=0.02)
KW = dict(generations=3, batch=24, root_seed=11, max_steps=600, cov_words=16,
          invariant=halt_inv)
# one workload object for the port's campaigns, so they share the
# generation cache (the engine.search rule)
WL = t_raft()
CFG = tcore.EngineConfig(**CFG_KW)
PLAN = raft_plan(tch, name="device-explore-test")


def _jax(**kw):
    return jx.run(j_raft(), JCfg(**CFG_KW), raft_plan(jch, name="device-explore-test"),
                  **dict(KW, **kw))


def _host(**kw):
    return tx.run(WL, CFG, PLAN, device="cpu", **dict(KW, **kw))


def _dev(**kw):
    return tx.run_device(WL, CFG, PLAN, device="cpu", **dict(KW, **kw))


@pytest.fixture(scope="module")
def full_jax_fp():
    """The uninterrupted campaign every checkpoint case splices against."""
    return fingerprint(_jax())


def test_device_matches_host_and_layouts():
    """The JAX package's host campaign, the port's host campaign and the
    port's device campaign (with ``layout`` and ``pool_index``, which
    change nothing) agree, the generation-0 seed corpus included."""
    seed_lp = raft_plan(tch, name="device-explore-test").literalize(3)
    j_seed = raft_plan(jch, name="device-explore-test").literalize(3)
    want = fingerprint(_jax(seed_corpus=(j_seed,)))
    host = _host(seed_corpus=(seed_lp,))
    dev = _dev(seed_corpus=(seed_lp,))
    dense = _dev(seed_corpus=(seed_lp,), layout="dense", pool_index=True)
    assert fingerprint(host) == want
    assert fingerprint(dev) == want
    assert fingerprint(dense) == want
    assert dev.host_syncs == 3 and host.host_syncs == 0
    assert seed_lp.name in {e.plan.name for e in dev.corpus}


def test_violations_dedup_and_replay():
    kw = dict(invariant=biased_inv, generations=2)
    dev = _dev(**kw)
    assert fingerprint(dev) == fingerprint(_jax(**kw))
    assert fingerprint(dev) == fingerprint(_host(**kw))
    assert dev.violations, "the biased invariant must flag seeds"
    e = dev.violations[-1]
    r = tx.replay_entry(WL, CFG, e, invariant=biased_inv, max_steps=800, device="cpu")
    assert int(r.traces[0]) == e.trace
    assert int(r.failing_seeds[0]) == e.seed


def test_checkpoint_interop_host_to_device(tmp_path, full_jax_fp):
    p = str(tmp_path / "camp.json")
    _host(generations=2, checkpoint_path=p)
    resumed = _dev(generations=1, resume=p)
    assert fingerprint(resumed) == full_jax_fp
    assert resumed.generations == 3
    assert resumed.host_syncs == 1 and resumed.wall_gens == 1
    assert "1 summary syncs / 1 generations" in resumed.banner()


def test_checkpoint_interop_device_to_host(tmp_path, full_jax_fp):
    p = str(tmp_path / "camp.json")
    _dev(generations=2, checkpoint_path=p)
    resumed = _host(generations=1, resume=p)
    assert fingerprint(resumed) == full_jax_fp


def test_checkpoints_resume_across_the_packages(tmp_path, full_jax_fp):
    """A checkpoint the JAX package saved resumes in the port (on both
    drivers), and one the port saved resumes in the JAX package; each
    spliced campaign equals the uninterrupted one. The two files are the
    same JSON document."""
    pj, pt = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    _jax(generations=2, checkpoint_path=pj)
    _dev(generations=2, checkpoint_path=pt)
    with open(pj) as a, open(pt) as b:
        assert json.load(a) == json.load(b)
    assert fingerprint(_dev(generations=1, resume=pj)) == full_jax_fp
    assert fingerprint(_host(generations=1, resume=pj)) == full_jax_fp
    assert fingerprint(_jax(generations=1, resume=pt)) == full_jax_fp
    state = tx.load_campaign(pj)
    assert state.to_dict() == jx.load_campaign(pj).to_dict()


def test_telemetry_one_sync_per_generation():
    records = []
    rep = _dev(telemetry=records.append, generations=2, batch=8, metrics=True)
    gens = [r for r in records if r["event"] == "generation"]
    assert len(gens) == 2
    for r in gens:
        assert r["host_syncs"] is None  # counted only under counted_syncs on the card
        assert "dispatch_wall_s" in r and "sync_wall_s" in r
        assert set(r["parts_ms"]) == set(tdev.PARTS)
        assert len(r["met_total"]) == tcore.N_METRICS and sum(r["met_total"]) > 0
    assert records[-1]["event"] == "campaign_end" and records[-1]["host_syncs"] is None
    assert rep.host_syncs == 2  # the consume points
    for r in records:
        json.dumps(r)
    assert "host sync" in rep.banner()


def test_host_driver_banner_reports_wall_split():
    rep = _host(generations=1, batch=8)
    assert rep.wall_dispatch_s > 0.0
    assert "batched dispatch" in rep.banner()


def test_a_second_campaign_builds_nothing():
    """The generation cache: a campaign of the same shape with another
    root seed reuses the built generation (the library is loaded:
    ``compile_wall_s`` 0.0 in every generation)."""
    records = []
    _dev(generations=1, batch=8)
    before = tdev.gen_cache_stats()["entries"]
    _dev(generations=2, batch=8, root_seed=99, telemetry=records.append)
    assert tdev.gen_cache_stats()["entries"] == before
    assert [r["compile_wall_s"] for r in records if r["event"] == "generation"] == [0.0, 0.0]


def test_requires_traceable_invariant():
    with pytest.raises(ValueError, match="traceable"):
        _dev(invariant=None)


def test_viol_store_overflow_raises():
    with pytest.raises(RuntimeError, match="viol_cap"):
        _dev(viol_cap=2, generations=1, batch=8, invariant=lambda v: v["halted"] & False)


def test_mesh_waits_for_parallel():
    """The JAX package's two mesh cases: a batch that does not split over
    the mesh's devices raises its error, and a world of one rank (gloo,
    a ``file://`` store) runs the unsharded campaign, with its start
    record's ``mesh_devices``. ``tests/test_torch_parallel.py`` holds
    worlds of several ranks."""
    import types

    import torch

    fake = types.SimpleNamespace(size=8, rank=0, device=torch.device("cpu"), group=None)
    with pytest.raises(ValueError, match="does not split over 8 mesh devices"):
        _dev(mesh=fake, batch=12)
    from _torch_world import one_rank_world

    from madsim_tpu_torch.parallel import make_mesh

    with one_rank_world():
        records = []
        got = _dev(mesh=make_mesh(device="cpu"), telemetry=records.append)
    assert fingerprint(got) == fingerprint(_dev())
    assert records[0]["mesh_devices"] == 1


def test_history_screens_hunt_equals_the_host_campaign():
    """A kvchaos lost-write hunt judged by the device screens
    (``history_check``) equals the JAX package's host campaign under the
    screens' numpy checkers (``stale_reads & read_your_writes``)."""
    kw = dict(generations=2, batch=16, root_seed=5, max_steps=1500, cov_words=16)
    cfg = dict(pool_size=96, loss_p=0.05)
    want = jx.run(j_kv(writes=5, record=True, bug=True, chaos=False), JCfg(**cfg), kv_plan(jch),
                  history_invariant=lambda h: j_stale(h) & j_ryw(h), **kw)
    got = tx.run_device(t_kv(writes=5, record=True, bug=True, chaos=False),
                        tcore.EngineConfig(**cfg), kv_plan(tch), invariant=None,
                        history_check=(tdc.stale_reads(), tdc.read_your_writes()),
                        device="cpu", **kw)
    assert fingerprint(got) == fingerprint(want)
    assert got.violations
