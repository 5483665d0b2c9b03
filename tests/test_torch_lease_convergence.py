"""The etcd lease convergence (``_torch_lease.py``) on the CPU: the
batched side's new kernel library and the host side's etcd server, each
held against the JAX package.

The batched side is leasekv-record without its own chaos, whose client 1
stalls its keepalives at ``ka_stop_ms`` (``tests/test_leasekv.py``'s
``TestDualModeConvergence`` scenario): the registry carries it as the
library ``leasekv-record-nochaos``, whose g++ host build equals the
plain step per field at 64 seeds, with any stall time and with none, and
the port's plain step equals the JAX engine per field on the scenario.
The host side is the etcd simulator with three lease clients, on either
package's runtime: equal logs at seeds 0, 1 and 7.

The window, in whole seconds of simulated time, fixed here against the
JAX package: lease 1 expires at 6 s on the host side (``HOST_EXPIRY_S``,
on every one of seeds 0..63 of the JAX package's etcd server), and at 7 s
on the batched side's server clock; the batched second less the host's
lies in ``CARD_MINUS_HOST_S`` = [0, 2], the JAX test's window. Exact
seconds, no float tolerance.
"""

import _torch_threads  # noqa: F401

import numpy as np
import pytest

import madsim_tpu as jms
import madsim_tpu_torch as tms
from madsim_tpu.models import make_leasekv as j_make
from madsim_tpu_torch.check.history import OK_FAIL, OK_OK
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.models import SOAK_SPECS
from madsim_tpu_torch.models.leasekv import OP_EXPIRE, OP_WATCH_EVT
from madsim_tpu_torch.models import make_leasekv as t_make

import _torch_lease as lease
from _torch_host import assert_host_matches_plain, build_host_kernel
from _torch_parity import run_both

KEY = "leasekv-record-nochaos"
KW = dict(pool_size=lease.POOL, loss_p=0.0)
SEEDS = np.arange(64, dtype=np.uint64)


def _verdicts(t):
    return lease.card_verdicts(t["hist_word"], t["hist_count"], OP_EXPIRE, OP_WATCH_EVT,
                               OK_OK, OK_FAIL)


def test_the_registry_carries_the_stalled_chaos_free_variant():
    wl = t_make(**lease.FACTORY_KW)
    spec = fused.kernel_model(wl)
    assert spec.key == KEY and len(fused.MODELS) == 43
    assert spec.shape == fused.workload_shape(wl) == (5, 6, 2, 0, 6, 15, (), 3)
    assert spec.cxx == "madsim::LeaseKvModel<true, false, false, 1, false>"
    assert spec.words == ("puts", "ttl_ms", "ka_ms", "scan_ms", "put_ms", "ka_stop_ms")
    cfg = tcore.EngineConfig(**KW)
    assert fused.config_words(wl, cfg)[9:] == (6, 5000, 1000, 1000, 1_000_000, 2000)
    # one build carries no stall at all: None passes a word past any clock
    free = t_make(chaos=False, record=True)
    assert fused.kernel_model(free).key == KEY
    assert fused.config_words(free, cfg)[-1] == fused.NO_WORD == 2**63 - 1
    # the other leasekv libraries keep their five words; the stall under
    # the model's own chaos derives a library that reads the sixth
    for key in ("leasekv", "leasekv-record", "leasekv-bug", "leasekv-army"):
        assert fused.MODELS[key].words == fused._LEASE_WORDS
        assert "ka_stop_ms" not in dict(fused.MODELS[key].fixed)
    for kw, key in ((dict(ka_stop_ms=2000), "leasekv-stall"),
                    (dict(ka_stop_ms=2000, record=True), "leasekv-record-stall"),
                    (dict(chaos=False), "leasekv-nochaos")):
        spec = fused.kernel_model(t_make(**kw))
        assert spec.key == key and spec.words == (*fused._LEASE_WORDS, "ka_stop_ms")


def test_the_scenario_matches_the_jax_engine_per_field():
    """The port's plain step on the convergence scenario equals the JAX
    engine per field (64 seeds, pool 48, loss 0, 140 steps), and every
    seed's verdict is the contract's."""
    t = run_both(j_make(**lease.FACTORY_KW), t_make(**lease.FACTORY_KW), KW, SEEDS,
                 lease.STEPS, until_halted=False)
    assert not t["halted"].any() and t["overflow"].sum() == 0
    assert set(map(repr, _verdicts(t))) == {repr(([1], [2, 3], [7], [1]))}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp(KEY), fused.MODELS[KEY], (lease.POOL,))


@pytest.mark.parametrize("stall", [2000, 500, None])
def test_host_build_matches_plain_step(host_lib, stall):
    """The new library's device code, built with g++, equals the plain
    step per field at 64 seeds, for the scenario's stall, an earlier one
    and none (one build, the stall a runtime word)."""
    wl = t_make(**dict(lease.FACTORY_KW, ka_stop_ms=stall))
    want = assert_host_matches_plain(host_lib, wl, tcore.EngineConfig(**KW), SEEDS,
                                     lease.STEPS, False)
    expired = {tuple(v[0]) for v in _verdicts(want)}
    assert expired == ({(1,)} if stall is not None else {()})


def test_host_build_runs_to_halt_without_chaos(host_lib):
    """The default words without chaos or a stall: every client finishes
    its puts, and the run to halt equals the plain step."""
    wl = t_make(chaos=False, record=True)
    cfg = tcore.EngineConfig(**SOAK_SPECS["leasekv"][1])
    want = assert_host_matches_plain(host_lib, wl, cfg, SEEDS[:32], 4000, True)
    assert want["halted"].all() and (want["epoch"] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_host_side_matches_the_jax_package(seed):
    """The etcd server and three lease clients on either package's
    runtime: equal logs, lease 1 expired in the window, 2 and 3 alive,
    and only lease 1's key deleted."""
    got = lease.lease_cluster(tms, seed)
    assert got == lease.lease_cluster(jms, seed)
    expired, alive, secs = lease.host_verdict(got)
    assert (expired, alive, got["keys"]) == ([1], [2, 3], ["/svc/2", "/svc/3"])
    lo, hi = lease.HOST_EXPIRY_S
    assert all(lo <= s <= hi for s in secs)


def test_the_window_is_the_jax_packages():
    """The host window of ``_torch_lease`` is where the JAX package's
    etcd server expires lease 1 on seeds 0..63; the batched side's
    second less it lies in the JAX test's window on seeds 1..16."""
    seconds = {lease.host_verdict(lease.lease_cluster(jms, s))[2][0] for s in range(64)}
    assert (min(seconds), max(seconds)) == lease.HOST_EXPIRY_S
    t = run_both(j_make(**lease.FACTORY_KW), t_make(**lease.FACTORY_KW), KW,
                 np.arange(17, dtype=np.uint64), lease.STEPS, until_halted=False)
    card = _verdicts(t)
    for seed in range(1, 17):
        host = lease.host_verdict(lease.lease_cluster(tms, seed))
        assert lease.check_seed(card[seed], host) is None
