"""leasekv (the lease/watch KV service under client-crash chaos, default
variant) in the torch port against the JAX package, and its device
handlers (csrc/model_leasekv.cuh) built for the host against the plain
step. Fifteen handlers; lease expiry is decided on the handling node's
own clock, ``ctx.now`` (the engine clock plus the node's skew). The C++
oracle does not cover this family, so the halted state is also held to
the service's own invariants. Exact equality."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import madsim_tpu.engine as je
from madsim_tpu.models import make_leasekv as j_make
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_from_numpy, state_to_numpy
from madsim_tpu_torch.models import SOAK_SPECS
from madsim_tpu_torch.models import make_leasekv as t_make

from _torch_host import assert_host_matches_plain, build_host_kernel, host_run
from _torch_parity import (
    assert_same_state, assert_soak_spec, assert_workload_equal, jax_fields, run_both,
)

NAME = "leasekv"
_F, KW, _N, CAP = SOAK_SPECS[NAME]
SEEDS = np.arange(64, dtype=np.uint64) * np.uint64(7919)
MID = 80  # fixed steps: before the first seed halts
WATCHER = 4


def _service_invariants(t):
    """At halt the server saw every client's FIN; its stream head counts
    its expiries; the watcher is never ahead of the head and appended no
    more events than its position."""
    server, watcher = t["node_state"][:, 0], t["node_state"][:, WATCHER]
    assert (server[:, 4] == 0b111).all()
    assert (server[:, 3] == server[:, 5]).all()
    assert (watcher[:, 0] <= server[:, 3]).all()
    assert (watcher[:, 1] <= watcher[:, 0]).all()


def test_soak_spec_and_workload_equal_reference():
    b2 = dict(clog_backoff_max_ns=2_000_000_000)
    assert_soak_spec(NAME, t_make, {}, dict(pool_size=48, loss_p=0.02, **b2), 4096, 4000)
    assert_workload_equal(j_make(), t_make())
    assert fused.workload_shape(t_make()) == fused.MODELS[NAME].shape


def test_soak_run_while_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, CAP, until_halted=True)
    assert t["halted"].all() and t["overflow"].sum() == 0
    _service_invariants(t)
    # a killed client that came back re-granted through the restart
    assert (t["epoch"].sum(1) == 2).any()


def test_fixed_steps_mid_run_matches_reference_per_field():
    t = run_both(j_make(), t_make(), KW, SEEDS, MID, until_halted=False)
    assert t["ev_valid"].any(axis=1).all() and not t["halted"].all()


WORDS = dict(puts=3, ttl_ms=50, ka_ms=80, scan_ms=20, put_ms=30)


def test_runtime_words_follow_the_factory(host_lib):
    # keepalives slower than the TTL: leases expire and the watch stream
    # carries the expiries
    t = run_both(j_make(**WORDS), t_make(**WORDS), KW, SEEDS[:32], CAP,
                 until_halted=True)
    assert t["halted"].all() and (t["node_state"][:, 0, 5] > 0).all()
    _service_invariants(t)
    want = assert_host_matches_plain(host_lib, t_make(**WORDS), tcore.EngineConfig(**KW),
                                     SEEDS[:32], CAP, True)
    assert (want["node_state"][:, WATCHER, 1] > 0).all()


def test_skewed_clock_matches_reference(host_lib):
    """Handlers read ``ctx.now`` with the node's skew added: with the
    server's clock 90 ms ahead, leases expire early, alike in the JAX
    engine, the plain step and the host-built kernel."""
    jcfg, tcfg = je.EngineConfig(**KW), tcore.EngineConfig(**KW)
    js = je.make_init(j_make(**WORDS), jcfg, time32=False)(SEEDS[:16])
    skew = np.zeros(np.asarray(js.skew).shape, np.int32)
    skew[:, 0] = 90_000_000
    js = dataclasses.replace(js, skew=jnp.asarray(skew))
    ts = state_from_numpy(jax_fields(js))
    jo = jax.jit(je.make_run(j_make(**WORDS), jcfg, 150, layout="scatter",
                             time32=False))(js)
    to = tcore.make_run(t_make(**WORDS), tcfg, 150)(ts)
    assert_same_state(jo, to)
    got = state_to_numpy(host_run(host_lib, t_make(**WORDS), tcfg, ts, 150, False))
    for name, want in state_to_numpy(to).items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    unskewed = tcore.make_run(t_make(**WORDS), tcfg, 150)(
        tcore.make_init(t_make(**WORDS), tcfg, device="cpu")(SEEDS[:16]))
    # the server stores its deadlines in its own, skewed, milliseconds
    assert (to.node_state[:, 0, :3] != unskewed.node_state[:, 0, :3]).any()


@pytest.mark.parametrize("kw", [dict(ka_stop_ms=200), dict(chaos=False)],
                         ids=["ka_stop", "no_chaos"])
def test_cpu_variants_match_reference(kw):
    run_both(j_make(**kw), t_make(**kw), KW, SEEDS[:16], 200, until_halted=False)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_kernel(tmp_path_factory.mktemp(NAME), fused.MODELS[NAME],
                             (KW["pool_size"],))


@pytest.mark.parametrize("n_steps,until_halted", [(CAP, True), (MID, False)],
                         ids=["run_while", "fixed"])
def test_host_built_kernel_matches_plain_step(host_lib, n_steps, until_halted):
    want = assert_host_matches_plain(host_lib, t_make(), tcore.EngineConfig(**KW),
                                     SEEDS[:48], n_steps, until_halted)
    assert want["epoch"].max() >= 1


@pytest.mark.parametrize("kw", [dict(army=True)], ids=["army"])
def test_unported_modes_raise(kw):
    """The army variant waited for the latency markers; it builds now,
    and under its client army with the latency tap it equals the
    reference per field."""
    from _torch_army import army_only_both

    t = army_only_both("leasekv", kw, 16, 64, 300, SEEDS[:16])
    assert t["lat_count"].sum() > 0


@pytest.mark.parametrize("kw", [dict(record=True), dict(record=True, bug=True)],
                         ids=["record", "bug"])
def test_record_variants_match_reference_per_field(kw):
    """leasekv-record and leasekv-bug: grants, expiries, served puts and
    the watch stream, all 140 history rows equal."""
    t = run_both(j_make(**kw), t_make(**kw), KW, SEEDS[:16], CAP, until_halted=True)
    assert t["hist_word"].shape == (16, 140, 5) and (t["hist_count"] > 0).all()


@pytest.mark.parametrize(
    "kw,key", [(dict(chaos=False), "leasekv-nochaos"), (dict(n_clients=2), "leasekv-c2"),
               (dict(ka_stop_ms=200), "leasekv-stall")],
    ids=["no_chaos", "two_clients", "ka_stop"],
)
def test_kernel_refuses_other_variants(kw, key):
    """Carried since the libraries are derived from the workload: the
    variant's own library, its key stable and its compile-time shape the
    workload's, where no registered library fits."""
    wl = t_make(**kw)
    spec = fused.kernel_model(wl)
    assert spec.key == key and spec.key not in fused.MODELS
    assert spec.shape == fused.workload_shape(wl) and spec == fused.derive_model(wl)
