"""madsim_tpu_torch.lint's campaign, flight and check axes on the CPU,
against the JAX package:

* ``CAMPAIGN_AXES``, ``FLIGHT_AXES`` and ``CHECK_AXES`` are the JAX
  package's dictionaries, flag for flag;
* ``check_campaign`` through the plain step on raft-record
  (sharded-campaign's flags) and on the kvchaos client army with the
  causal columns (sharded-causal's): (a) a generation's children under
  perturbation, (b) the campaign's outcome with every generation's
  non-guidance derived columns perturbed, each control reported; the
  campaign equals the JAX package's ``explore.run_device`` of the same
  small campaign (violations, bits, curves and corpus ids), so the
  perturbed one does too;
* the sharded form on a spawned two-rank gloo world;
* the flight form under a ``FlightRecorder`` with its profiler on;
* the check axis on raft-record: the clean verdict equals the JAX
  package's ``screen_ok(default_screens(), ...)`` of its own run of the
  same seeds, the non-history perturbation leaves it equal, the history
  control moves it; a step entry raises;
* ``python -m madsim_tpu_torch.lint --noninterference``: ``--device cpu``
  runs the plain-step smoke, the default raises without a card.

The JAX package's own proof of these axes (a taint walk over jaxprs) is
not called here.
"""

import _torch_threads  # noqa: F401
import json

import numpy as np
import pytest
import torch

import jax

import madsim_tpu.engine as je
import madsim_tpu.explore as jx
import madsim_tpu.models as jm
from madsim_tpu.check import device as jdc
from madsim_tpu.lint import noninterference as jni
import madsim_tpu_torch.models as tm
from madsim_tpu_torch.check import device as tdc
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.lint import (
    CAMPAIGN_AXES,
    CHECK_AXES,
    FLIGHT_AXES,
    NonInterferenceReport,
    check_campaign,
    check_noninterference,
    cli,
    model_matrix,
)

from _torch_lint_axes import ARMY_CASE, RAFT_CASE, army_case, raft_case
from _torch_world import spawn_world

SEEDS = np.arange(16, dtype=np.uint64)
CHECK_STEPS = 120


def _plain(flags: dict) -> dict:
    """An axis row with its LatencySpec as its defining triple."""
    return {k: (v.ops, v.phases, v.phase_ns) if hasattr(v, "phase_ns") else v
            for k, v in flags.items()}


@pytest.mark.parametrize("ours,theirs", [(CAMPAIGN_AXES, jni.CAMPAIGN_AXES),
                                         (FLIGHT_AXES, jni.FLIGHT_AXES),
                                         (CHECK_AXES, jni.CHECK_AXES)],
                         ids=["campaign", "flight", "check"])
def test_the_axes_are_the_jax_packages(ours, theirs):
    assert {k: _plain(v) for k, v in ours.items()} == {k: _plain(v) for k, v in theirs.items()}


def _jax_flags(flags: dict) -> dict:
    """An axis row's campaign flags in the JAX package's classes (a
    campaign's sweep runs no ring)."""
    out = {k: v for k, v in flags.items() if k not in ("timeline_cap", "flight", "check")}
    if "latency" in out:
        lat = out["latency"]
        out["latency"] = je.LatencySpec(ops=lat.ops, phases=lat.phases, phase_ns=lat.phase_ns)
    return out


def _jax_campaign(case, run_kw: dict, flags: dict) -> dict:
    wl, cfg, plan, judge = case(port=False)
    rep = jx.run_device(wl, cfg, plan, invariant=judge.get("invariant"),
                        history_check=judge.get("history_check"), **run_kw, **_jax_flags(flags))
    return dict(violations=len(rep.violations), cov_bits=rep.coverage_bits,
                curve=[int(x) for x in rep.curve], viol_curve=[int(x) for x in rep.viol_curve],
                corpus_ids=[e.id for e in rep.corpus])


CASES = {
    "raft-record": (raft_case, RAFT_CASE, "sharded-campaign", tm.raft.ABSINT_HORIZON_NS),
    "kvchaos-army-causal": (army_case, ARMY_CASE, "sharded-causal",
                            tm.kvchaos.ABSINT_HORIZON_NS),
}


@pytest.mark.parametrize("name", list(CASES))
def test_campaign_axis_through_the_plain_step_equals_the_jax_campaign(name):
    case, run_kw, axis, horizon = CASES[name]
    wl, cfg, plan, judge = case()
    flags = CAMPAIGN_AXES[axis]
    rep = check_campaign(wl, cfg, plan, device="cpu", horizon_ns=horizon, **judge, **run_kw,
                         **flags)
    assert rep.ok, rep.summary()
    assert rep.entry == "campaign" and rep.n_seeds == run_kw["batch"] and not rep.outcome
    assert rep.controls["guidance"]["live"] and rep.controls["met-leak"]["live"]
    assert "step" in rep.controls["met-leak"]["reported"]
    c = rep.parts["campaign"]
    assert c["held_generation"] == run_kw["generations"] - 1 and c["children"] == run_kw["batch"]
    # (b) perturbs the non-guidance derived columns the view holds
    assert "cov" not in c["outcome_fields"] and "cov_hits" not in c["outcome_fields"]
    if name == "raft-record":
        assert {"met", "lat_hist"} <= set(c["outcome_fields"])
        assert "hist_word" not in c["outcome_fields"]
    else:
        assert {"lam", "ev_parent", "ev_lam"} <= set(c["outcome_fields"])
        assert {"lam", "tl_seq", "tl_parent"} <= set(rep.derived)
    got = {k: c[k] for k in ("violations", "cov_bits", "curve", "viol_curve", "corpus_ids")}
    jax_kw = {k: v for k, v in run_kw.items() if k != "perturb_seeds"}
    assert got == _jax_campaign(case, jax_kw, flags)
    # the report survives its JSON form
    d = json.loads(rep.to_json())
    assert NonInterferenceReport.from_dict(d).to_dict() == rep.to_dict()


def test_sharded_campaign_on_a_two_rank_gloo_world():
    """(a) through ``shard_over_seeds`` and (b) with the campaign on the
    mesh, each rank's view perturbed: the unsharded clean campaign's
    outcome on every rank."""
    rep = NonInterferenceReport.from_dict(spawn_world(2, cases="lint_axes_cases")["report"])
    assert rep.ok, rep.summary()
    assert rep.entry == "sharded-campaign" and not rep.outcome
    assert rep.parts["campaign"]["mesh"] == 2
    sharded = rep.parts["sharded"]
    assert sharded["ok"] and sharded["flags"]["mesh"] == 2
    assert sharded["entry"].startswith("shard_over_seeds(") and sharded["n_seeds"] == 16
    assert all(c["live"] for c in rep.controls.values())


def test_flight_campaign_under_a_flight_recorder():
    wl, cfg, plan, judge = raft_case()
    rep = check_campaign(wl, cfg, plan, device="cpu", horizon_ns=tm.raft.ABSINT_HORIZON_NS,
                         **judge, **dict(RAFT_CASE, perturb_seeds=(1,)),
                         **FLIGHT_AXES["flight-campaign"])
    assert rep.ok, rep.summary()
    f = rep.parts["flight"]
    # four campaigns (clean, one perturbed, the guidance control) of two
    # generations each, recorded; on the CPU no generation is counted
    assert f["equal"] and f["generations"] == 6 and f["records"] > f["generations"]
    assert f["host_syncs"] == []
    assert rep.entry == "flight-campaign" and rep.flags["flight"] is True


def _check_state(port: bool):
    flags = {k: v for k, v in CHECK_AXES["device-check"].items() if k != "check"}
    if port:
        wl, cfg = tm.make_raft(record=True), tcore.EngineConfig(**tm.raft.lint_entries()[1][2])
        return wl, cfg, tcore.make_init(wl, cfg, device="cpu", **flags)(SEEDS), flags
    wl, kw = jm.raft.lint_entries()[1][1:]
    cfg = je.EngineConfig(**kw)
    return wl, cfg, je.make_init(wl, cfg, **flags)(SEEDS), flags


def test_check_axis_on_raft_record_holds_the_verdict_to_the_history():
    wl, cfg, st, flags = _check_state(True)
    rep = check_noninterference(wl, cfg, seeds=st, n_steps=CHECK_STEPS,
                                horizon_ns=tm.raft.ABSINT_HORIZON_NS, **CHECK_AXES["device-check"])
    assert rep.ok, rep.summary()
    assert rep.flags["check"] is True and not rep.verdicts
    assert "hist_word" in rep.derived and "met" in rep.derived
    control = rep.controls["verdict"]
    assert control["live"] and control["seeds"] > 0
    # the clean verdict is the JAX package's over its own run
    out = tcore.make_run_plain(wl, cfg, CHECK_STEPS, **flags)(st)
    ours = tdc.screen_ok(tdc.default_screens(), out.hist_word, out.hist_t, out.hist_count,
                         out.hist_drop).numpy()
    jwl, jcfg, jst, _f = _check_state(False)
    jout = jax.jit(je.make_run(jwl, jcfg, CHECK_STEPS, **flags))(jst)
    theirs = np.asarray(jdc.screen_ok(jdc.default_screens(), jout.hist_word, jout.hist_t,
                                      jout.hist_count, jout.hist_drop))
    np.testing.assert_array_equal(ours, theirs)
    assert control["clean_failing"] == int((~theirs).sum())


def test_check_axis_needs_a_run_entry():
    wl, cfg, st, _f = _check_state(True)
    with pytest.raises(ValueError, match="run entry"):
        check_noninterference(wl, cfg, run=tcore.make_step_plain, seeds=st, n_steps=4,
                              chunks=1, **CHECK_AXES["device-check"])


def test_check_axis_reports_a_verdict_that_reads_derived_state():
    """A verdict that reads ``met`` (not a history column) is reported:
    the check holds the verdict to the history columns alone."""
    wl, cfg, st, _f = _check_state(True)
    rep = check_noninterference(
        wl, cfg, seeds=st, n_steps=CHECK_STEPS, perturb_seeds=(1,), ranges=False,
        verdict=lambda s: (s.met[:, tcore.MET_SENT] & 1) == 0,
        **{k: v for k, v in CHECK_AXES["device-check"].items() if k != "check"})
    assert not rep.ok and "verdict" in rep.verdicts, rep.summary()


def test_cli_device_cpu_runs_the_plain_step_smoke(capsys, tmp_path):
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    assert cli.main(["--noninterference", "--device", "cpu", "--format", "json",
                     str(clean)]) == 0
    doc = json.loads(capsys.readouterr().out)
    reps = doc["noninterference"]
    models = {tag: wl for tag, wl, _cfg, _h in model_matrix()}
    assert [(r["workload"], r["flags"]["axis"], r["entry"], r["ok"]) for r in reps] == [
        (models[tag].name, axis, "make_run_plain", True) for tag, axis in cli.SMOKE]


def test_cli_noninterference_defaults_to_the_card_and_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("holds the behaviour without a card")
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--noninterference", str(clean)])


def test_card_smoke_cells_have_their_builds():
    """Every card cell of the smoke names a library built at its pool,
    with the taps where it asks for them (no plain-step fallback)."""
    from madsim_tpu_torch.engine.fused import kernel_model

    for tag, wl, cfg, plan, steps, flags, _h in cli.card_smoke():
        spec = kernel_model(wl)
        assert cfg.pool_size in spec.pools, tag
        if any(flags.get(k) for k in ("cov_words", "timeline_cap", "causal")):
            assert cfg.pool_size in spec.obs_pools, tag
        assert steps % 4 == 0 and (plan is None or plan.slots > 0)


def test_counted_syncs_read_the_host_side_of_the_block():
    """``obs.prof.count_syncs`` counts the host's runtime calls inside its
    block's host range. The card's annotation of the block lasts until
    the card has run the block's work, so it can take in the profiler's
    own closing ``cudaDeviceSynchronize``, which is not the block's (as
    it did in the flight axis's counted generation on the card)."""
    from madsim_tpu_torch.obs import prof

    mark = prof._MARK
    trace = {"traceEvents": [
        {"name": mark, "cat": "user_annotation", "ts": 100, "dur": 100},
        {"name": mark, "cat": "gpu_user_annotation", "ts": 120, "dur": 300},
        {"name": "cudaEventSynchronize", "cat": "cuda_runtime", "ts": 150, "dur": 5,
         "args": {"correlation": 1}},
        {"name": "cudaDeviceSynchronize", "cat": "cuda_runtime", "ts": 300, "dur": 5,
         "args": {"correlation": 2}},
    ]}
    out = prof.SyncCount()
    prof._count_trace(trace, out)
    assert (out.syncs, out.pageable, out.names) == (1, 0, {"cudaEventSynchronize": 1})
