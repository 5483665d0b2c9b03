"""The fleet counters (``metrics=True``) in the port, against the JAX
package's, and through the runners.

* ``SimState.met`` of the plain step equals the JAX engine's
  (``make_run_while(layout="scatter", time32=False, metrics=True)``)
  for raft, kvchaos under a plan that mixes every fault spec with
  ``dup_rows``, raftlog-record, and raft under a time limit; the halt
  codes done, time limit and idle, each where it must show.
* Metrics change no trajectory: every other field equals the run
  without them.
* The state's counter row picks the kernel's instantiation; a run
  whose ``metrics=`` disagrees with it is refused.
* The runners with metrics are in ``test_torch_metrics_runners.py``.
* The run kernel's step code built with g++ (``tests/_torch_host.py``):
  raftlog-durable-record's metrics instantiation under the store soak's
  and the lying disk's plans, every field equal to the plain step.

Exact equality throughout.
"""

import numpy as np
import pytest
import torch

import jax

import madsim_tpu.chaos as jc
import madsim_tpu.engine as je
from madsim_tpu.models import make_kvchaos as j_kv
from madsim_tpu.models import make_raft as j_raft
from madsim_tpu.models import make_raftlog as j_raftlog
from madsim_tpu_torch import chaos as tc
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.models import make_kvchaos, make_raft, make_raftlog

from _torch_host import build_host_kernel, host_run
from _torch_parity import assert_same_state
from _torch_store_pins import STORE_KW, store_plans
from test_torch_plan import plans

SEEDS = np.arange(32, dtype=np.uint64)
RAFT_KW = dict(pool_size=40, loss_p=0.02)
# raft's clock stops at 200 ms: the seeds that have not elected by then
# halt on the time limit
LIMIT_KW = dict(RAFT_KW, time_limit_ns=200_000_000)

# case -> (JAX workload, port workload, engine kwargs, plan name or None,
# dup_rows, step cap, seeds); the mixed plan's runs are cut at 250 steps
CASES = {
    "raft": (j_raft, make_raft, RAFT_KW, None, False, 600, 32),
    "raft-time-limit": (j_raft, make_raft, LIMIT_KW, None, False, 600, 32),
    "kvchaos-mixed-dup": (lambda: j_kv(writes=5, chaos=False),
                          lambda: make_kvchaos(writes=5, chaos=False),
                          dict(pool_size=96, loss_p=0.02), "mixed", True, 250, 4),
    "raftlog-record": (lambda: j_raftlog(record=True), lambda: make_raftlog(record=True),
                       dict(pool_size=64, loss_p=0.02), None, False, 4000, 32),
}


def run_both(case, metrics=True):
    jf, tf, kw, plan, dup, cap, n = CASES[case]
    seeds = SEEDS[:n]
    jw, tw = jf(), tf()
    jcfg, tcfg = je.EngineConfig(**kw), tcore.EngineConfig(**kw)
    slots = plans(jc)[plan].slots if plan else 0
    jinit = je.make_init(jw, jcfg, time32=False, plan_slots=slots, metrics=metrics)
    tinit = tcore.make_init(tw, tcfg, device="cpu", plan_slots=slots, metrics=metrics)
    if plan:
        jst = jinit(seeds, plans(jc)[plan].compile_batch(seeds))
        tst = tinit(seeds, plans(tc)[plan].compile_batch(seeds))
    else:
        jst, tst = jinit(seeds), tinit(seeds)
    want = jax.jit(je.make_run_while(jw, jcfg, cap, layout="scatter", time32=False,
                                     dup_rows=dup, metrics=metrics))(jst)
    got = tcore.make_run_while_plain(tw, tcfg, cap, dup_rows=dup, metrics=metrics)(tst)
    assert_same_state(want, got)
    return got


@pytest.mark.parametrize("case", list(CASES))
def test_met_equals_the_reference(case):
    met = state_to_numpy(run_both(case))["met"]
    assert met.shape == (CASES[case][-1], tcore.N_METRICS)
    codes = met[:, tcore.MET_HALT_CODE]
    assert (met[:, tcore.MET_SENT] > 0).any() and (met[:, tcore.MET_RNG] > 0).all()
    if case == "raft-time-limit":
        assert set(codes) == {tcore.HALT_DONE, tcore.HALT_TIME_LIMIT}
    elif case == "kvchaos-mixed-dup":
        # cut at the cap: the running seeds keep HALT_RUNNING
        assert set(codes) <= {tcore.HALT_DONE, tcore.HALT_RUNNING}
    else:
        assert (codes == tcore.HALT_DONE).all()
    if case == "kvchaos-mixed-dup":
        for slot in (tcore.MET_DUP, tcore.MET_PAUSE, tcore.MET_CLOG_BLOCK, tcore.MET_CRASH):
            assert met[:, slot].sum() > 0, tcore.METRIC_NAMES[slot]
    if case == "raftlog-record":
        assert (met[:, tcore.MET_RECORD] > 0).all() and met[:, tcore.MET_CRASH].sum() > 0


def _idle_pair():
    """One node that emits nothing: its pool is empty after on_init."""
    def make(core):
        return core.Workload(name="idle", n_nodes=1, state_width=1,
                             handlers=(lambda ctx: (ctx.state, ctx.emits().build()),),
                             max_emits=1)

    return make(je), make(tcore)


def test_the_idle_halt_code():
    jw, tw = _idle_pair()
    kw = dict(pool_size=4)
    jst = je.make_init(jw, je.EngineConfig(**kw), time32=False, metrics=True)(SEEDS[:4])
    want = jax.jit(je.make_run(jw, je.EngineConfig(**kw), 5, layout="scatter",
                               time32=False, metrics=True))(jst)
    got = tcore.make_run_plain(tw, tcore.EngineConfig(**kw), 5, metrics=True)(
        tcore.make_init(tw, tcore.EngineConfig(**kw), device="cpu", metrics=True)(SEEDS[:4]))
    assert_same_state(want, got)
    assert (got.met[:, tcore.MET_HALT_CODE] == tcore.HALT_IDLE).all()
    assert (got.met[:, tcore.MET_RNG] == 1 + 2).all() and not got.halted.any()


@pytest.mark.parametrize("case", ["raft", "raftlog-record"])
def test_metrics_change_no_trajectory(case):
    jf, tf, kw, plan, dup, cap, n = CASES[case]
    wl, cfg, seeds = tf(), tcore.EngineConfig(**kw), SEEDS[:n]
    runs = []
    for metrics in (False, True):
        init = tcore.make_init(wl, cfg, device="cpu", plan_slots=plans(tc)[plan].slots
                               if plan else 0, metrics=metrics)
        st = init(seeds, plans(tc)[plan].compile_batch(seeds)) if plan else init(seeds)
        runs.append(tcore.make_run_while_plain(wl, cfg, cap, dup_rows=dup, metrics=metrics)(st))
    for f in tcore.STATE_FIELDS:
        if f != "met":
            assert getattr(runs[0], f).equal(getattr(runs[1], f)), f
    assert runs[0].met.shape[1] == 0 and runs[1].met.shape[1] == tcore.N_METRICS


@pytest.fixture(scope="module")
def durable_record_lib(tmp_path_factory):
    wl = make_raftlog(record=True, chaos=False, durable=True)
    spec = fused.kernel_model(wl)
    assert spec.key == "raftlog-durable-record" and spec.sync
    return build_host_kernel(tmp_path_factory.mktemp("durable"), spec, (STORE_KW["pool_size"],))


@pytest.mark.parametrize("plan", ["store", "lie"])
def test_host_built_metrics_kernel_under_storage_plans(durable_record_lib, plan):
    wl, cfg = make_raftlog(record=True, chaos=False, durable=True), \
        tcore.EngineConfig(**STORE_KW)
    p, seeds = store_plans(tc)[plan], SEEDS[:8]
    st = tcore.make_init(wl, cfg, device="cpu", plan_slots=p.slots, metrics=True)(
        seeds, p.compile_batch(seeds, wl=wl))
    want = state_to_numpy(tcore.make_run_while_plain(wl, cfg, 6000, metrics=True)(st))
    got = state_to_numpy(host_run(durable_record_lib, wl, cfg, st, 6000, True))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    met = want["met"]
    assert met[:, tcore.MET_SYNC].min() > 0
    assert met[:, tcore.MET_TORN if plan == "store" else tcore.MET_SYNC_LOST].sum() > 0
    # and without metrics the met column stays the input's
    st0 = tcore.make_init(wl, cfg, device="cpu", plan_slots=p.slots)(
        SEEDS[:8], p.compile_batch(SEEDS[:8], wl=wl))
    out = host_run(durable_record_lib, wl, cfg, st0, 6000, True)
    assert out.met is st0.met and torch.equal(
        out.disk, tcore.make_run_while_plain(wl, cfg, 6000)(st0).disk)


@pytest.mark.parametrize("with_row", [False, True])
def test_the_counter_row_picks_the_kernel(with_row):
    """The state's ``met`` row picks the run kernel's instantiation, and a
    run whose ``metrics=`` disagrees with it is refused."""
    wl, cfg = make_raft(), tcore.EngineConfig(**RAFT_KW)
    st = tcore.make_init(wl, cfg, device="cpu", metrics=with_row)(SEEDS[:2])
    assert fused.has_metrics(st) is with_row
    assert ("met" in fused._unwritten(st)) is not with_row
    fused._check_metrics(st, with_row)
    with pytest.raises(ValueError, match=f"metrics={not with_row}"):
        fused._check_metrics(st, not with_row)
