"""``madsim_tpu_torch.parallel``: seed sharding over a ``torch.distributed``
world, against the unsharded runs and the JAX package's merges.

One spawned gloo world of three ranks (a ``file://`` store, no port) runs
every case of ``tests/_torch_world.py`` per rank; the module's tests hold
rank 0's results against one process:

* ``shard_run_compacted`` with ``hist_screen`` on kvchaos-bug (60 seeds,
  20 a rank, shrink 2, min size 4) equals ``make_run_compacted`` per
  field, the screen verdicts and folds included (``step`` is each
  shard's own phase schedule's, as in the JAX package); an uneven batch
  raises the JAX package's error;
* ``shard_over_seeds(make_run_while)`` equals the unsharded run;
* the four merges, each rank passing its rows, equal the one-device
  merges of the whole batch and the JAX package's;
* ``run_device(mesh=)`` (3 generations of 24, 8 a rank) equals
  ``run_device()`` and the JAX package's host campaign; its start record
  names the world's size, and an uneven batch raises;
* ``make_mesh()`` on a gloo world asks for a device.

Exact equality throughout.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest

from _torch_explore import fingerprint, halt_inv, raft_plan
from _torch_world import (
    COMPACT_STEPS,
    DEVICE_RUN,
    case_inputs,
    compact_case,
    spawn_world,
)

import madsim_tpu.chaos as jch
import madsim_tpu.explore as jx
import madsim_tpu.parallel as jpar
from madsim_tpu.engine import EngineConfig as JCfg
from madsim_tpu.models import make_raft as j_raft
import madsim_tpu_torch.chaos as tch
import madsim_tpu_torch.explore as tx
import madsim_tpu_torch.models as tm
from madsim_tpu_torch import parallel as par
from madsim_tpu_torch.check import device as tdc
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.compact import RESULT_FIELDS, SCREEN_FIELDS, make_run_compacted

WORLD = 3


@pytest.fixture(scope="module")
def world():
    return spawn_world(WORLD)


@pytest.fixture(scope="module")
def compact_solo():
    wl, cfg, seeds, screens = compact_case(tm, tcore, tdc)
    st = tcore.make_init(wl, cfg, device="cpu")(seeds)
    return st, make_run_compacted(wl, cfg, COMPACT_STEPS, shrink=2, min_size=4,
                                  hist_screen=screens)(st)


def test_shard_run_compacted_equals_unsharded(world, compact_solo):
    _st, solo = compact_solo
    got = world["compacted"]
    assert set(got) == set(RESULT_FIELDS + SCREEN_FIELDS)
    for f in RESULT_FIELDS + SCREEN_FIELDS:
        if f == "step":
            continue
        np.testing.assert_array_equal(got[f], getattr(solo, f), err_msg=f)
    assert got["hist_fold"].sum() > 0 and not got["hist_ok"].all()


def test_shard_run_compacted_rejects_uneven_split(world):
    # the JAX package's text for a batch that does not split
    assert world["uneven"] == "59 seeds do not split over 3 devices"


def test_gloo_mesh_needs_a_device(world):
    """Only an NCCL world defaults to the card; a gloo world runs where
    the caller says."""
    assert world["mesh_default"] == (
        "make_mesh on a gloo world needs device= (for example 'cpu'); only "
        "an NCCL world defaults to the card")


def test_shard_over_seeds_equals_the_lockstep_run(world, compact_solo):
    st, _solo = compact_solo
    wl, cfg, _seeds, _screens = compact_case(tm, tcore, tdc)
    ref = tcore.make_run_while(wl, cfg, COMPACT_STEPS)(st)
    np.testing.assert_array_equal(world["lockstep_trace"], ref.trace.numpy())
    np.testing.assert_array_equal(world["lockstep_hist_word"], ref.hist_word.numpy())


def test_the_four_merges_equal_one_device_and_the_reference(world):
    inp = case_inputs()
    cases = (
        ("merge_coverage", inp["cov"]),
        ("merge_metrics", inp["met"]),
        ("merge_latency", inp["lat"]),
        ("merge_verdicts", inp["ok"]),
    )
    for name, x in cases:
        one = getattr(par, name)(x)
        ref = np.asarray(getattr(jpar, name)(x))
        np.testing.assert_array_equal(one, ref, err_msg=name)
        np.testing.assert_array_equal(world[name], one, err_msg=name)
        assert world[name].dtype == one.dtype == ref.dtype, name
    assert world["verdicts_uneven"] == (
        "93 verdicts do not split over 3 devices in word-aligned (multiple-of-32) shards")


def test_run_device_mesh_equals_unsharded(world):
    cfg_kw = dict(pool_size=64, loss_p=0.02)
    solo = tx.run_device(tm.make_raft(), tcore.EngineConfig(**cfg_kw),
                         raft_plan(tch, name="device-explore-test"), invariant=halt_inv,
                         device="cpu", **DEVICE_RUN)
    ref = jx.run(j_raft(), JCfg(**cfg_kw), raft_plan(jch, name="device-explore-test"),
                 invariant=halt_inv, **DEVICE_RUN)
    got = world["device"]
    assert fingerprint(got) == fingerprint(solo) == fingerprint(ref)
    assert got.host_syncs == DEVICE_RUN["generations"] and got.corpus
    recs = world["device_records"]
    assert recs[0]["event"] == "campaign_start" and recs[0]["mesh_devices"] == WORLD
    assert all(r["host_syncs"] is None for r in recs if r["event"] == "generation")
    assert world["device_uneven"] == "batch=25 does not split over 3 mesh devices"
