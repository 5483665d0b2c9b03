"""The port's seed search against the JAX package's.

For the raft and kvchaos cases of ``tests/test_search.py`` the port's
``search_seeds`` (the plain step on the CPU, with ``compact`` off and
on) finds the reference's failing seeds, with its traces, verdicts and
``banner()`` text; a failing seed reproduces alone; overflowed seeds
are quarantined as in the reference. Exact equality.
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest

import madsim_tpu.engine as je
from madsim_tpu.models import make_kvchaos as j_kvchaos
from madsim_tpu.models import make_raft as j_raft
from madsim_tpu_torch.check.device import election_safety
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import search
from madsim_tpu_torch.engine.compact import RESULT_FIELDS
from madsim_tpu_torch.engine.search import make_sweep, search_seeds
from madsim_tpu_torch.models import make_kvchaos, make_microbench, make_raft
from madsim_tpu_torch.models.raft import OP_ELECT


def has_leader(v):
    return (v["node_state"][:, :, 0] == 2).any(axis=1)


def all_replicas_current(v):
    # too strong on purpose: a chaos kill wipes a RAM-only replica's
    # apply counter, and the re-sync replays only the current write
    return (np.asarray(v["node_state"])[:, 1:5, 1] >= 5).all(axis=1)


# name -> (JAX factory, port factory, engine kwargs, invariant, seeds, cap)
CASES = {
    "raft": (j_raft, make_raft, dict(pool_size=48, loss_p=0.02), has_leader, 256, 600),
    "kvchaos": (
        lambda: j_kvchaos(writes=5), lambda: make_kvchaos(writes=5),
        dict(pool_size=48, loss_p=0.02), all_replicas_current, 512, 900,
    ),
    "raft-overflow": (j_raft, make_raft, dict(pool_size=8, loss_p=0.02), has_leader, 64, 600),
}


@pytest.fixture(scope="module")
def reference():
    """The JAX package's report of each case, one compile each."""
    out = {}
    for name, (jf, _tf, kw, inv, n, cap) in CASES.items():
        out[name] = je.search_seeds(jf(), je.EngineConfig(**kw), inv, n_seeds=n, max_steps=cap)
    return out


def _port(name, compact, **kw):
    _jf, tf, ekw, inv, n, cap = CASES[name]
    return search_seeds(tf(), tcore.EngineConfig(**ekw), inv, n_seeds=n, max_steps=cap,
                        compact=compact, device="cpu", **kw)


@pytest.mark.parametrize("compact", [False, True], ids=["lockstep", "compact"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_search_matches_reference(reference, name, compact):
    ref, got = reference[name], _port(name, compact)
    np.testing.assert_array_equal(got.seeds, ref.seeds)
    assert got.traces.dtype == ref.traces.dtype == np.uint64
    np.testing.assert_array_equal(got.traces, ref.traces)
    np.testing.assert_array_equal(got.overflowed, ref.pool_overflowed)
    for attr in ("ok", "halted", "overflowed", "halt_times"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(ref, attr), err_msg=attr)
    for attr in ("failing_seeds", "unhalted_seeds", "overflowed_seeds"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(ref, attr), err_msg=attr)
    assert got.banner() == ref.banner()
    assert got.workload == ref.workload and got.config_hash == ref.config_hash
    assert got.build_wall_s == 0.0
    if not compact:
        assert got.steps == ref.steps
    if name == "kvchaos":
        assert 0 < got.failing_seeds.size < 512
    if name == "raft":
        assert "0 violation(s)" in got.banner() and got.unhalted_seeds.size == 0
    if name == "raft-overflow":
        assert got.overflowed_seeds.size > 0
        assert "overflowed the event pool" in got.banner()


def test_failing_seed_reproduces_in_isolation(reference):
    batch = reference["kvchaos"]
    bad = int(batch.failing_seeds[0])
    wl, cfg = make_kvchaos(writes=5), tcore.EngineConfig(pool_size=48, loss_p=0.02)
    solo = search_seeds(wl, cfg, all_replicas_current, n_seeds=1, max_steps=900,
                        seed_base=bad, device="cpu")
    assert solo.failing_seeds.tolist() == [bad]
    assert int(solo.traces[0]) == int(batch.traces[list(batch.seeds).index(bad)])
    again = search_seeds(wl, cfg, all_replicas_current, seeds=np.array([bad, bad + 1]),
                         max_steps=900, compact=True, device="cpu")
    assert int(again.traces[0]) == int(solo.traces[0])


def test_compact_view_holds_the_result_fields():
    seen = {}

    def inv(v):
        seen.update(v)
        return has_leader(v)

    search_seeds(make_raft(), tcore.EngineConfig(pool_size=40, loss_p=0.02), inv,
                 n_seeds=16, max_steps=600, compact=True, device="cpu")
    assert set(seen) == set(RESULT_FIELDS)


def test_invariant_shape_is_validated():
    wl, cfg = make_microbench(rounds=5), tcore.EngineConfig(pool_size=8)
    with pytest.raises(ValueError, match="boolean array"):
        search_seeds(wl, cfg, lambda v: np.bool_(True), n_seeds=8, max_steps=50, device="cpu")


def test_search_reuses_built_run():
    cfg = tcore.EngineConfig(pool_size=40, loss_p=0.02)
    before = len(search._RUN_CACHE)
    search_seeds(make_raft(), cfg, has_leader, n_seeds=8, max_steps=200, device="cpu")
    search_seeds(make_raft(), cfg, has_leader, n_seeds=8, max_steps=200, device="cpu")
    assert len(search._RUN_CACHE) == before + 1


def test_sweep_returns_the_final_state():
    wl, cfg = make_raft(), tcore.EngineConfig(pool_size=40, loss_p=0.02)
    view = make_sweep(wl, cfg, 600, device="cpu")(np.arange(8))
    want = tcore.make_run_while(wl, cfg, 600)(tcore.make_init(wl, cfg, device="cpu")(np.arange(8)))
    for f, v in view.items():
        assert v.equal(getattr(want, f)), f


@pytest.mark.parametrize(
    "option,item",
    [("device_check", "ported"), ("plan", "ported"),
     ("plan_rows", "ported"), ("dup_rows", "ported"), ("cov_words", "ported"),
     ("metrics", "ported"),
     ("timeline_cap", "ported"), ("latency", "A8"), ("causal", "A8"), ("retry", "A8")],
)
def test_unported_options_raise_naming_their_item(option, item):
    from madsim_tpu_torch.chaos import FaultPlan, PauseStorm

    value = {"cov_words": 2, "timeline_cap": 8, "metrics": True, "causal": True,
             "dup_rows": True}.get(option, object())
    cfg = tcore.EngineConfig(pool_size=40)
    if option == "retry":
        # A8 ported it: a client army's policy arms the engine's timers,
        # derived from the plan or given with its rows; a sweep takes it
        from madsim_tpu_torch.chaos import RetryPolicy
        from madsim_tpu_torch.models import kvchaos

        wl = make_kvchaos(writes=4, n_replicas=2, chaos=False, army=True)
        plan = FaultPlan((kvchaos.client_army(n_ops=4, t_min_ns=5_000_000, t_max_ns=80_000_000,
                                              n_replicas=2,
                                              retry=RetryPolicy(timeout_ns=5_000_000)),))
        kcfg, rt = tcore.EngineConfig(pool_size=48), plan.retry_spec()
        rows = plan.compile_batch(np.arange(4, dtype=np.uint64), wl=wl)
        ones = lambda v: np.ones(v["halted"].shape[0], bool)  # noqa: E731
        kw = dict(n_seeds=4, max_steps=400, metrics=True, require_halt=False, device="cpu")
        derived = search_seeds(wl, kcfg, ones, plan=plan, **kw)
        given = search_seeds(wl, kcfg, ones, plan_rows=rows, retry=rt, **kw)
        off = search_seeds(wl, kcfg, ones, plan_rows=rows, **kw)
        np.testing.assert_array_equal(derived.met, given.met)
        np.testing.assert_array_equal(derived.traces, given.traces)
        assert derived.met[:, tcore.MET_RETRY].sum() > 0 and not off.met[:, tcore.MET_RETRY:].any()
        view = make_sweep(wl, kcfg, 400, device="cpu", plan_slots=plan.slots, metrics=True,
                          retry=rt)(np.arange(4, dtype=np.uint64), rows)
        np.testing.assert_array_equal(view["trace"].numpy().view(np.uint64), given.traces)
        with pytest.raises(TypeError, match="RetrySpec or None"):
            search_seeds(wl, kcfg, ones, plan_rows=rows, retry=object(), **kw)
        return
    if option == "causal":
        # A8 ported it: the final clocks come back and nothing else moves
        on = search_seeds(make_raft(), cfg, has_leader, n_seeds=4, max_steps=10,
                          device="cpu", causal=True, timeline_cap=8)
        off = search_seeds(make_raft(), cfg, has_leader, n_seeds=4, max_steps=10,
                           device="cpu", timeline_cap=8)
        np.testing.assert_array_equal(on.traces, off.traces)
        assert on.lam.shape == (4, 5) and on.lam.any() and off.lam is None
        assert on.timeline.tl_seq.shape == (4, 8) and not hasattr(off.timeline, "tl_seq")
        return
    if option == "latency":
        # A8 ported it: raft marks no op, so its sketches stay empty and
        # its traces are those of the sweep without the tap
        on = search_seeds(make_raft(), cfg, has_leader, n_seeds=4, max_steps=10,
                          device="cpu", latency=tcore.LatencySpec(ops=4, phases=2))
        off = search_seeds(make_raft(), cfg, has_leader, n_seeds=4, max_steps=10,
                           device="cpu")
        np.testing.assert_array_equal(on.traces, off.traces)
        assert on.lat_hist.shape == (4, 2, tcore.N_LAT_BUCKETS) and not on.lat_hist.any()
        assert not on.lat_count.any() and not on.lat_dropped.any()
        assert off.lat_hist is None and off.lat_count is None
        return
    if item == "ported":
        plan = FaultPlan((PauseStorm(targets=(0, 1, 2)),))
        if option == "device_check":
            # validated, not refused: raft without record=True has no
            # histories to screen
            with pytest.raises(ValueError, match="Workload.history=None"):
                search_seeds(make_raft(), cfg, has_leader,
                             n_seeds=4, max_steps=10, device="cpu",
                             **{option: election_safety(OP_ELECT)})
        elif option == "plan":
            rep = search_seeds(make_raft(), cfg, has_leader, n_seeds=4, max_steps=10,
                               device="cpu", plan=plan)
            assert rep.plan_hash == plan.hash()
        elif option == "plan_rows":
            with pytest.raises(ValueError, match="plan_rows carries 4 rows for 5 seeds"):
                search_seeds(make_raft(), cfg, has_leader, n_seeds=5, max_steps=10,
                             device="cpu", plan_rows=plan.compile_batch(np.arange(4)))
            with pytest.raises(ValueError, match="plan OR plan_rows"):
                search_seeds(make_raft(), cfg, has_leader, n_seeds=4, max_steps=10,
                             device="cpu", plan=plan, plan_rows=plan.compile_batch(np.arange(4)))
        elif option == "metrics":
            rep = search_seeds(make_raft(), cfg, has_leader, n_seeds=4, max_steps=10,
                               device="cpu", metrics=True)
            assert rep.met.shape == (4, tcore.N_METRICS) and (rep.met[:, tcore.MET_RNG] > 0).all()
        elif option in ("cov_words", "timeline_cap"):
            rep = search_seeds(make_raft(), cfg, has_leader, n_seeds=4, max_steps=10,
                               device="cpu", **{option: value})
            if option == "cov_words":
                assert rep.cov.shape == (4, 2) and rep.cov.any() and rep.timeline is None
            else:
                assert rep.timeline.tl_t.shape == (4, 8) and rep.cov is None
                assert (rep.timeline.tl_count > 0).all()
        else:
            # no plan duplicates anything: the shadow rows change nothing
            on, off = (search_seeds(make_raft(), cfg, has_leader, n_seeds=4, max_steps=10,
                                    device="cpu", dup_rows=d) for d in (True, False))
            np.testing.assert_array_equal(on.traces, off.traces)
        return
    with pytest.raises(NotImplementedError, match=item):
        search_seeds(make_raft(), cfg, has_leader,
                     n_seeds=4, max_steps=10, device="cpu", **{option: value})
