"""The storage libraries' step code built with g++
(``tests/_torch_host.py``), against the plain step in every field:
raftlog-durable without and with metrics, raftlog-nosync-record under
the store soak's plan with them (``test_torch_metrics.py`` builds
raftlog-durable-record). Exact equality.
"""

import numpy as np
import pytest

from madsim_tpu_torch import chaos as tc
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.models import raftlog as trl

from _torch_host import build_host_kernel, host_run
from _torch_store_pins import STORE_KW, store_plans

SEEDS = np.arange(16, dtype=np.uint64)
TPLANS = store_plans(tc)


# the run kernel's step code built with g++: the storage libraries but
# raftlog-durable-record (test_torch_metrics.py builds that one), with
# the metrics instantiations they run
HOST_CASES = {
    "raftlog-durable": (dict(durable=True), dict(pool_size=64, loss_p=0.02), None, 4000,
                        (False, True)),
    "raftlog-nosync-record": (dict(record=True, chaos=False, durable=True, bug="nosync"),
                              STORE_KW, "store", 6000, (True,)),
}


@pytest.mark.parametrize("key", list(HOST_CASES))
def test_host_built_storage_kernel_equals_the_plain_step(tmp_path_factory, key):
    fkw, kw, plan, cap, metrics_on = HOST_CASES[key]
    wl, cfg = trl.make_raftlog(**fkw), tcore.EngineConfig(**kw)
    spec = fused.kernel_model(wl)
    assert spec.key == key and spec.sync and kw["pool_size"] in spec.pools
    lib = build_host_kernel(tmp_path_factory.mktemp(key), spec, (kw["pool_size"],))
    seeds = SEEDS
    for metrics in metrics_on:
        init = tcore.make_init(wl, cfg, device="cpu", plan_slots=TPLANS[plan].slots
                               if plan else 0, metrics=metrics)
        st = init(seeds, TPLANS[plan].compile_batch(seeds, wl=wl)) if plan else init(seeds)
        want = state_to_numpy(tcore.make_run_while_plain(wl, cfg, cap, metrics=metrics)(st))
        got = state_to_numpy(host_run(lib, wl, cfg, st, cap, True))
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert want["disk"].shape == (16, 5, 12) and want["met"][:, tcore.MET_CRASH].sum() > 0
