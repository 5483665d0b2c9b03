"""The store soak's missing-sync hunt and the latency soak's guided SLO
hunt on the port, against the JAX package's at a small batch on the CPU
(``tests/_torch_hunt_pins.py`` runs both packages through one code path):

* the store hunt (raftlog durable, record, nosync at the store config
  under ``STORE_PLAN``, 2 x 32 from root 3, a 1,500-step cap): the
  violations, coverage bits, both curves, the first find, its replay and
  kind, its shrink (events, rounds, probes, trace), the shrunk plan's
  replay and the sha256 of ``obs.explain``'s text;
* the SLO hunt (the soak's army workload at pool 160 over the blip
  space, 2 x 32 from root 12): the uniform sweep's calibration at the
  same budget, the guided campaign, its first breach's shrink and
  replay, and ``explain`` with a 4,096-row ring and the latency tap;
* ``chip_smoke.py``'s copy of the soak-scale pins equals the pins
  script's, and the two workloads map to their new taps builds.

Each small root was chosen so that the campaign finds something to
shrink; the soak-scale runs are ``chip_smoke.py`` phases 67-68.
"""

import _torch_threads  # noqa: F401
import sys
from pathlib import Path

import pytest

import jax  # noqa: F401  (the JAX package's engine, on the CPU)

from madsim_tpu_torch.engine import fused

import _torch_hunt_pins as hp

ROOT = Path(__file__).resolve().parent.parent
STORE_SMALL = dict(hp.STORE_RUN, generations=2, batch=32, root_seed=3, max_steps=1500)
SLO_SMALL = dict(hp.SLO_RUN, generations=2, batch=32, root_seed=12)


@pytest.mark.parametrize("hunt,run_kw", [(hp.store_hunt, STORE_SMALL),
                                         (hp.slo_hunt, SLO_SMALL)], ids=["store", "slo"])
def test_the_hunt_equals_the_jax_packages(hunt, run_kw):
    ours = hunt(hp.package(port=True), run_kw, dict(device="cpu"))
    theirs = hunt(hp.package(port=False), run_kw)
    assert ours == theirs
    # something was found, shrunk, replayed and told
    assert ours["viol"] > 0 and ours["replay"] == (True, True)
    assert len(ours["shrink"]["events"]) < ours["shrink"]["original"]
    assert len(ours["explain"]) == 64
    if "narrates" in ours:
        assert ours["narrates"] == (True, True) and ours["uniform"][3] == 0
    else:
        assert ours["shrunk_replay"] == (True, True)


def test_chip_smoke_pins_are_the_pins_scripts():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert chip_smoke.HUNT_PINS == hp.HUNT_PINS
    assert chip_smoke.STORE_HUNT_RUN == hp.STORE_RUN
    assert chip_smoke.SLO_HUNT_RUN == hp.SLO_RUN
    assert (chip_smoke.SLO_Q, chip_smoke.SLO_MIN_OPS, chip_smoke.SLO_RING) == (
        hp.SLO_Q, hp.SLO_MIN_OPS, hp.SLO_RING)


def test_the_hunts_have_their_taps_builds():
    p = hp.package(port=True)
    store = p.raftlog.make_raftlog(record=True, chaos=False, durable=True, bug="nosync")
    wl, cfg, _spec, _space = hp.slo_space(p)
    for w, pool, key in ((store, hp.STORE_KW["pool_size"], "raftlog-nosync-record"),
                         (wl, cfg.pool_size, "kvchaos-army-nochaos")):
        spec = fused.kernel_model(w)
        assert spec.key == key and spec.obs_pools == (pool,)
