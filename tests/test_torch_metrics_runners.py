"""The runners with the fleet counters (``metrics=True``), in the port
against the JAX package: ``search_seeds`` returns the JAX package's
``met`` and halt-reason banner; ``make_run_compacted`` banks ``met``
and ``disk`` as the JAX package's does; a checkpoint carries both,
both ways; ``check_determinism`` compares both. Exact equality.
"""

import numpy as np
import pytest

import jax

import madsim_tpu.engine as je
from madsim_tpu.engine.compact import make_run_compacted as j_compacted
from madsim_tpu.models import make_raft as j_raft
from madsim_tpu.models import make_raftlog as j_raftlog
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.checkpoint import load, save
from madsim_tpu_torch.engine.compact import make_run_compacted
from madsim_tpu_torch.engine.search import search_seeds
from madsim_tpu_torch.engine.verify import DeterminismError, check_determinism, compare_fields
from madsim_tpu_torch.models import make_raft, make_raftlog

from _torch_parity import assert_same_state, jax_fields

SEEDS = np.arange(32, dtype=np.uint64)
# raft's clock stops at 200 ms: the seeds that have not elected by then
# halt on the time limit
LIMIT_KW = dict(pool_size=40, loss_p=0.02, time_limit_ns=200_000_000)


def test_search_reports_met_and_the_halt_reasons():
    kw = dict(n_seeds=32, max_steps=600, metrics=True)
    want = je.search_seeds(j_raft(), je.EngineConfig(**LIMIT_KW), lambda v: v["halted"], **kw)
    got = search_seeds(make_raft(), tcore.EngineConfig(**LIMIT_KW), lambda v: v["halted"],
                       device="cpu", **kw)
    np.testing.assert_array_equal(got.met, want.met)
    line = got.banner().splitlines()[1]
    assert line == want.banner().splitlines()[1]
    assert "workload-halt" in line and "time-limit" in line
    plain = search_seeds(make_raft(), tcore.EngineConfig(**LIMIT_KW), lambda v: v["halted"],
                         n_seeds=32, max_steps=600, device="cpu")
    assert plain.met is None
    np.testing.assert_array_equal(plain.traces, got.traces)


def test_compacted_banks_met_and_disk():
    """raftlog durable=True with metrics, in phases of 8, 4 and 2 rows:
    every banked field, ``met`` and ``disk`` among them, equals the JAX
    package's compacted run."""
    seeds = np.arange(8, dtype=np.uint64)
    kw = dict(pool_size=64, loss_p=0.02)
    args = dict(max_steps=4000, shrink=2, min_size=2, metrics=True)
    jw, jcfg = j_raftlog(durable=True), je.EngineConfig(**kw)
    want = j_compacted(jw, jcfg, **args)(
        je.make_init(jw, jcfg, time32=False, metrics=True)(seeds))
    wl, cfg = make_raftlog(durable=True), tcore.EngineConfig(**kw)
    got = make_run_compacted(wl, cfg, **args)(
        tcore.make_init(wl, cfg, device="cpu", metrics=True)(seeds))
    for f in ("met", "disk", "node_state", "trace", "step", "halted"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
    assert got.disk.shape == (8, 5, 12) and (got.met[:, tcore.MET_SYNC] > 0).all()


def test_checkpoint_carries_disk_and_met_both_ways(tmp_path):
    kw = dict(pool_size=64, loss_p=0.02)
    jw, jcfg = j_raftlog(durable=True), je.EngineConfig(**kw)
    wl, cfg = make_raftlog(durable=True), tcore.EngineConfig(**kw)
    split = 120
    jrun = jax.jit(je.make_run(jw, jcfg, split, layout="scatter", time32=False, metrics=True))
    jmid = jrun(je.make_init(jw, jcfg, time32=False, metrics=True)(SEEDS))
    path = str(tmp_path / "ref.npz")
    je.save_checkpoint(path, jmid, jcfg)
    mid = load(path, cfg, device="cpu")
    assert_same_state(jmid, mid)
    assert mid.met[:, tcore.MET_SYNC].min() > 0 and mid.disk.shape == (32, 5, 12)
    save(str(tmp_path / "port.npz"), mid, cfg)
    back = je.load_checkpoint(str(tmp_path / "port.npz"), jcfg, time32=False)
    want, got = jax_fields(jrun(jmid)), jax_fields(jrun(back))
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    resumed = tcore.make_run(wl, cfg, split, metrics=True)(mid)
    assert_same_state(jrun(jmid), resumed)


def test_check_determinism_holds_disk_and_met():
    wl, cfg = make_raftlog(durable=True), tcore.EngineConfig(pool_size=64, loss_p=0.02)
    check_determinism(wl, cfg, SEEDS[:4], 100, device="cpu", metrics=True)
    st = tcore.make_run(wl, cfg, 100, metrics=True)(
        tcore.make_init(wl, cfg, device="cpu", metrics=True)(SEEDS[:4]))
    for f in ("met", "disk"):
        other = tcore.SimState(**{g: getattr(st, g).clone() for g in tcore.STATE_FIELDS})
        getattr(other, f)[3].view(-1)[0] += 1
        with pytest.raises(DeterminismError, match=f"field '{f}' diverged at seed index 3"):
            compare_fields(st, other, fields=(f,))
