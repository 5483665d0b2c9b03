"""madsim_tpu_torch/engine/core.py against the JAX engine.

The config hash, the kind constants, the meta word and the trace fold
equal the reference's; and a tiny 3-node workload, written once for
each framework, that emits every engine kind raft never does (kill,
restart, pause/resume, link and node clogs, halt) under loss gives the
same SimState, field by field, exactly. The reference is the JAX engine
on the CPU built with ``layout="scatter", time32=False``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import madsim_tpu.engine as je
from madsim_tpu.engine import core as jcore
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.models import make_raft

from _torch_chaos3 import CHAOS3_COMMON, CHAOS_CFG, N3, chaos3_spec, chaos3_workload
from _torch_parity import assert_same_state



@pytest.mark.parametrize(
    "kw",
    [
        {},
        dict(pool_size=40, loss_p=0.02, clog_backoff_max_ns=2_000_000_000),
        dict(pool_size=128, loss_p=1.0, time_limit_ns=5_000_000_000),
        dict(lat_min_ns=7, lat_max_ns=7, proc_min_ns=3, proc_max_ns=3),
    ],
)
def test_engine_config_hash_equals_reference(kw):
    t, j = tcore.EngineConfig(**kw), je.EngineConfig(**kw)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    assert t.hash() == j.hash()
    assert t.loss_u32 == j.loss_u32


def test_engine_config_rejects_what_the_reference_rejects():
    for kw in (dict(lat_min_ns=10, lat_max_ns=5), dict(proc_min_ns=0, proc_max_ns=2**33)):
        with pytest.raises(ValueError):
            je.EngineConfig(**kw)
        with pytest.raises(ValueError):
            tcore.EngineConfig(**kw)


def test_kind_constants_equal_reference():
    names = [n for n in dir(jcore) if n.startswith("KIND_")]
    names = [n for n in names if getattr(jcore, n) < jcore.FIRST_EXT_KIND]
    assert len(names) == 10
    for n in names + ["FIRST_USER_KIND", "FIRST_EXT_KIND"]:
        assert getattr(tcore, n) == getattr(jcore, n), n
    assert [tcore.user_kind(i) for i in range(5)] == [jcore.user_kind(i) for i in range(5)]
    assert tcore._TRACE_PRIME == int(jcore._TRACE_PRIME)
    assert tcore._TRACE_MIX % 2**64 == int(jcore._TRACE_MIX)


def test_meta_pack_and_unpack_equal_reference():
    rs = np.random.default_rng(0)
    kind, node1, src1, retry = (rs.integers(0, 256, size=512).astype(np.int32) for _ in range(4))
    j = np.asarray(jcore._meta_pack(*(jnp.asarray(x) for x in (kind, node1, src1, retry))))
    t = tcore._meta_pack(*(torch.from_numpy(x) for x in (kind, node1, src1, retry)))
    np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))
    jm = jnp.asarray(j)
    for jf, tf in (
        (jcore._meta_kind, tcore._meta_kind), (jcore._meta_node, tcore._meta_node),
        (jcore._meta_src, tcore._meta_src), (jcore._meta_retry, tcore._meta_retry),
    ):
        np.testing.assert_array_equal(tf(t).numpy(), np.asarray(jf(jm)))


@pytest.mark.parametrize("w", [0, 3])
def test_trace_fold_equals_reference(w):
    rs = np.random.default_rng(1 + w)
    s = 256
    trace = rs.integers(0, 2**64, size=s, dtype=np.uint64)
    now = rs.integers(0, 2**62, size=s, dtype=np.int64)
    kind = rs.integers(0, 256, size=s).astype(np.int32)
    node = rs.integers(-1, 6, size=s).astype(np.int32)
    args = rs.integers(-(2**31), 2**31, size=(s, 4)).astype(np.int32)
    pay = rs.integers(-(2**31), 2**31, size=(s, w)).astype(np.int32)
    want = np.asarray(jax.vmap(jcore._trace_fold)(
        jnp.asarray(trace), jnp.asarray(now), jnp.asarray(kind),
        jnp.asarray(node), jnp.asarray(args), jnp.asarray(pay),
    ))
    got = tcore._trace_fold(
        torch.from_numpy(trace.view(np.int64)), torch.from_numpy(now),
        torch.from_numpy(kind), torch.from_numpy(node), torch.from_numpy(args),
        torch.from_numpy(pay),
    )
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_workload_validation_and_emit_capacity():
    h = (lambda ctx: (ctx.state, ctx.emits().build()),)
    for kw in (dict(args_words=1), dict(max_emits=60), dict(durable_cols=(7,)),
               dict(draw_purposes=(-1,))):
        with pytest.raises(ValueError):
            tcore.Workload(name="w", n_nodes=2, state_width=2, handlers=h, **kw)
    eb = tcore.EmitBuilder(1, 0, 2, 4, "cpu")
    eb.halt()
    with pytest.raises(ValueError, match="max_emits"):
        eb.halt()
    with pytest.raises(ValueError, match="args_words"):
        tcore.EmitBuilder(2, 0, 2, 4, "cpu").send(0, 10, (1, 2, 3))


# ---------------------------------------------------------------------------
# a tiny 3-node workload in both frameworks that emits every engine kind
# ---------------------------------------------------------------------------


def _chaos_handlers_jax():
    uk = jcore.user_kind

    def on_init(ctx):
        eb = ctx.emits()
        d = ctx.draw.user_int(1_000_000, 5_000_000, 0)
        eb.after(d, uk(1), ctx.node, (1,))
        eb.send((ctx.node + 1) % N3, uk(2), (ctx.node, 0))
        return ctx.state.at[2].add(1), eb.build()

    def on_tick(ctx):
        st = ctx.state
        r = ctx.draw.user_int(0, 8, 1)
        peer, other = (ctx.node + 1) % N3, (ctx.node + 2) % N3
        eb = ctx.emits()
        eb.kill(peer, when=r == 0)
        eb.restart_after(2_000_000, peer, when=(r == 0) | (r == 1))
        eb.pause(other, when=r == 2)
        eb.resume(other, when=r == 3)
        eb.clog_link(ctx.node, peer, when=r == 4)
        eb.unclog_link(ctx.node, peer, when=(r == 5) | (r == 2))
        eb.after(0, jcore.KIND_CLOG_NODE, 0, (other,), when=r == 6)
        eb.after(0, jcore.KIND_UNCLOG_NODE, 0, (other,), when=r >= 6)
        eb.send(peer, uk(2), (ctx.node, 0), when=r != 7)
        eb.after(3_000_000 + ctx.draw.user_int(0, 2_000_000, 2), uk(1), ctx.node, (1,))
        eb.halt(when=(st[0] >= 6) & (ctx.node == 0))
        return st.at[0].add(1), eb.build()

    def on_ping(ctx):
        st = ctx.state
        eb = ctx.emits()
        eb.send(ctx.src, uk(2), (ctx.node, ctx.args[1] + 1), when=ctx.args[1] < 3)
        return st.at[1].set(ctx.src + 10 * ctx.args[1]).at[0].add(1), eb.build()

    return (on_init, on_tick, on_ping)


def _chaos_workloads():
    return (
        jcore.Workload(handlers=_chaos_handlers_jax(), **CHAOS3_COMMON),
        chaos3_workload(),
    )


@pytest.mark.parametrize("n_steps", [1, 150])
def test_engine_kinds_match_reference_per_field(n_steps):
    jwl, twl = _chaos_workloads()
    jcfg, tcfg = je.EngineConfig(**CHAOS_CFG), tcore.EngineConfig(**CHAOS_CFG)
    seeds = np.arange(48, dtype=np.uint64) * np.uint64(0x9E3779B1)
    js = je.make_init(jwl, jcfg, time32=False)(seeds)
    ts = tcore.make_init(twl, tcfg, device="cpu")(seeds)
    assert_same_state(js, ts)
    jo = jax.jit(je.make_run(jwl, jcfg, n_steps, layout="scatter", time32=False))(js)
    to = tcore.make_run(twl, tcfg, n_steps)(ts)
    assert_same_state(jo, to)
    if n_steps > 1:
        # the run really went through the engine kinds it is here for
        t = state_to_numpy(to)
        assert (~t["alive"]).any() and t["epoch"].max() >= 2
        assert t["paused"].any() and t["clog"].any() and t["halted"].any()
        assert (t["ev_meta"] >> 24).max() > 0  # clog/pause reschedules
        assert not t["halted"].all() and t["overflow"].sum() == 0


def test_fused_wrapper_refuses_what_the_kernel_does_not_carry():
    _jwl, twl = _chaos_workloads()
    with pytest.raises(NotImplementedError, match="carries no model 'chaos3'.*make_run_plain"):
        fused.kernel_model(twl)
    raft = make_raft()
    spec = fused.kernel_model(raft)
    st = tcore.make_init(raft, tcore.EngineConfig(pool_size=40), device="cpu")(np.arange(2))
    with pytest.raises(ValueError, match="CUDA"):
        fused.check_state(spec, raft, st)
    # a state built for another workload or pool is refused before launch
    cst = tcore.make_init(twl, tcore.EngineConfig(pool_size=40), device="cpu")(np.arange(2))
    with pytest.raises(ValueError, match="the workload.s is"):
        fused.check_state(spec, raft, cst)
    # any pool: the launch builds the library at the state's pool, so
    # a CPU state is refused only for its device
    with pytest.raises(ValueError, match="CUDA"):
        fused.check_state(spec, raft, tcore.make_init(raft, tcore.EngineConfig(pool_size=24), device="cpu")(np.arange(2)))
    assert fused.library_at(spec, 24).key == "raft-p24"
    with pytest.raises(ValueError, match="ev_meta"):
        fused.check_state(spec, raft, dataclasses.replace(st, ev_meta=st.ev_meta.to(torch.int32)))
    # a registered name at another variant derives its own library; at
    # a shape that is not its trait's it is refused
    four = fused.kernel_model(make_raft(n_nodes=4))
    assert four.key == "raft-n4" and four.shape == fused.workload_shape(make_raft(n_nodes=4))
    with pytest.raises(NotImplementedError, match="compiled for 'raft-election'"):
        fused.kernel_model(dataclasses.replace(raft, state_width=7))


@pytest.mark.parametrize("until_halted", [False, True], ids=["fixed", "while"])
def test_engine_kinds_in_the_kernel_code_match_plain_step(tmp_path, until_halted):
    """The kernel's engine step (host build) on the chaos3 workload
    equals the plain step, which the test above holds against JAX."""
    from _torch_host import build_host_kernel, host_run

    spec = chaos3_spec(tmp_path)
    lib = build_host_kernel(tmp_path, spec, spec.pools)
    _jwl, twl = _chaos_workloads()
    tcfg = tcore.EngineConfig(**CHAOS_CFG)
    words = (
        tcfg.lat_min_ns, tcfg.lat_max_ns, tcfg.loss_u32, tcfg.proc_min_ns,
        tcfg.proc_max_ns, tcfg.clog_backoff_min_ns, tcfg.clog_backoff_max_ns,
        tcfg.time_limit_ns,
    )
    seeds = np.arange(48, dtype=np.uint64) * np.uint64(0x9E3779B1)
    st = tcore.make_init(twl, tcfg, device="cpu")(seeds)
    run = tcore.make_run_while_plain if until_halted else tcore.make_run_plain
    want = state_to_numpy(run(twl, tcfg, 150)(st))
    got = state_to_numpy(host_run(lib, twl, tcfg, st, 150, until_halted, words))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert want["paused"].any() and want["clog"].any() and (~want["alive"]).any()
