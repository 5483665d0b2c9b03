"""The port's fault-plan compiler (``madsim_tpu_torch/chaos/plan.py``)
against the JAX package's.

Every fault spec, and a plan that mixes them, compiles at 64 seeds
(uint64 seeds past 2^63 among them) to the JAX package's ``PlanRows``:
time, kind, args, valid and node, exactly. ``FaultPlan.hash`` and
``LiteralPlan.hash`` give the JAX package's strings (the banner's
``(seed, config, plan)`` repro key), as do ``slots``, ``uses_dup``,
``min_pool_size``, ``compile``, ``literalize``, ``clamped`` and
``stack_plan_rows``; the validation errors are the JAX package's.
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

import madsim_tpu.chaos.plan as jp
from madsim_tpu.engine.rng import np_threefry2x32 as j_threefry
from madsim_tpu.models import make_kvchaos as j_kv
from madsim_tpu_torch.chaos import plan as tp
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.rng import np_threefry2x32v, threefry2x32
from madsim_tpu_torch.models import make_kvchaos as t_kv
from madsim_tpu_torch.models import make_raft as t_raft

SEEDS = np.arange(64, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
ROWS = ("time", "kind", "args", "valid", "node")


def specs(m):
    """One instance of every fault spec, in module ``m``'s classes."""
    return {
        "crash": m.CrashStorm(targets=(1, 2, 3), n=2),
        "pause": m.PauseStorm(targets=(0, 1), n=2, t_min_ns=5, t_max_ns=500),
        "partition": m.Partition(targets=(0, 1, 2, 3)),
        "asymmetric": m.Partition(targets=(0, 1, 2), asymmetric=True),
        "partial": m.Partition(targets=(1, 2, 3), partial_p=0.5),
        "flapping": m.FlappingPartition(targets=(1, 2, 3), n_cycles=2,
                                        asymmetric=True, partial_p=0.8),
        "gray": m.GrayFailure(targets=(0, 1, 2, 3), n_links=2, mult_min=2, mult_max=64),
        "dup": m.Duplicate(),
        "skew": m.ClockSkew(targets=(0, 1, 2), n=2),
        "disk": m.DiskFault(targets=(1, 2), n_torn=1, n_sync_loss=1, n_eio=1),
    }


def plans(m):
    out = {k: m.FaultPlan((s,), name=k) for k, s in specs(m).items()}
    out["mixed"] = m.FaultPlan(tuple(specs(m).values()), name="mixed")
    return out


def _same_rows(t, j):
    for f in ROWS:
        want = np.asarray(getattr(j, f))
        got = getattr(t, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("name", [*specs(tp), "mixed"])
def test_compile_equals_the_reference(name):
    t, j = plans(tp)[name], plans(jp)[name]
    _same_rows(t.compile_batch(SEEDS), j.compile_batch(SEEDS))
    assert t.hash() == j.hash()
    assert (t.slots, t.uses_dup()) == (j.slots, j.uses_dup())
    wl = t_kv(writes=5, chaos=False)
    assert t.min_pool_size(wl) == j.min_pool_size(j_kv(writes=5, chaos=False))
    assert t.min_pool_size(wl, tile_align=False) == j.min_pool_size(
        j_kv(writes=5, chaos=False), tile_align=False)
    assert t.compile(int(SEEDS[9])) == [
        tp.FaultEvent(e.t, e.kind, e.a0, e.a1, e.node) for e in j.compile(int(SEEDS[9]))]
    assert t.describe(3) == j.describe(3)
    assert [tuple(vars(x).values()) for x in t.slot_templates()] == [
        tuple(vars(x).values()) for x in j.slot_templates()]


def test_literal_plans_equal_the_reference():
    t, j = plans(tp)["mixed"], plans(jp)["mixed"]
    tl, jl = t.literalize(5), j.literalize(5)
    assert tl.hash() == jl.hash() and tl.name == jl.name
    assert tl.to_dict() == jl.to_dict()
    _same_rows(tl.compile_batch(SEEDS[:4]), jl.compile_batch(SEEDS[:4]))
    # a masked literal: the disabled slots stay reserved
    mask = tuple(bool(i % 3) for i in range(tl.slots))
    tm = tp.LiteralPlan(events=tl.events, enabled=mask)
    jm = jp.LiteralPlan(events=jl.events, enabled=mask)
    assert tm.hash() == jm.hash() and tm.uses_dup() == jm.uses_dup()
    _same_rows(tm.compile_batch(SEEDS[:3]), jm.compile_batch(SEEDS[:3]))
    assert tp.LiteralPlan.from_dict(tm.to_dict()) == tm
    # per-seed literals stacked into one batch
    seeds = [1, 2, 3]
    _same_rows(tp.stack_plan_rows([t.literalize(s) for s in seeds]),
               jp.stack_plan_rows([j.literalize(s) for s in seeds]))


def test_the_nemesis_plan_hash_is_the_reference_repro_key():
    """The kv nemesis plan of the JAX package's soak (NEMESIS_r08.txt)."""
    def kv_plan(m):
        return m.FaultPlan((m.CrashStorm(
            targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
            down_min_ns=50_000_000, down_max_ns=250_000_000),), name="kv-nemesis")

    assert kv_plan(tp).hash() == kv_plan(jp).hash() == "cc8aed3abe641fb1"


def test_windows_clamp_and_warn_like_the_reference():
    t = tp.FaultPlan((tp.CrashStorm(targets=(1,), t_min_ns=50, t_max_ns=90),
                      tp.Duplicate(t_min_ns=5, t_max_ns=10)))
    j = jp.FaultPlan((jp.CrashStorm(targets=(1,), t_min_ns=50, t_max_ns=90),
                      jp.Duplicate(t_min_ns=5, t_max_ns=10)))
    with pytest.warns(UserWarning, match="cannot fire"):
        assert len(t.validate_windows(40)) == 1
    assert t.validate_windows(100, warn=False) == []
    assert t.clamped(60).hash() == j.clamped(60).hash()
    _same_rows(t.clamped(60).compile_batch(SEEDS), j.clamped(60).compile_batch(SEEDS))
    with pytest.raises(ValueError, match="time_limit_ns must be > 0"):
        t.clamped(0)


def test_validation_errors_are_the_reference():
    """TestPlanCompilation's checks in tests/test_chaos.py, and each
    spec's argument errors."""
    bad = [
        (lambda m: m.CrashStorm(targets=(1,), t_min_ns=0, t_max_ns=5_000_000_000),
         "does not fit uint32"),
        (lambda m: m.CrashStorm(targets=()), "at least one target"),
        (lambda m: m.CrashStorm(targets=(1,), n=0), "n must be >= 1"),
        (lambda m: m.Partition(targets=(1,)), "at least two target"),
        (lambda m: m.Partition(targets=(0, 1), partial_p=0.0), "partial_p"),
        (lambda m: m.FlappingPartition(targets=(0, 1), n_cycles=0), "n_cycles"),
        (lambda m: m.GrayFailure(targets=(0, 1), mult_min=3, mult_max=2), "multiplier range"),
        (lambda m: m.GrayFailure(targets=(0, 1), mult_max=tcore.SLOW_MULT_MAX + 1),
         "packed args word"),
        (lambda m: m.ClockSkew(targets=(0,), skew_min_ns=-(2**31)), "int32"),
        (lambda m: m.DiskFault(targets=(0,), n_torn=0), "at least one torn"),
        (lambda m: m.FaultPlan(()), "at least one fault spec"),
        (lambda m: m.LiteralPlan(events=(m.FaultEvent(1, 0),), enabled=(True, False)),
         "enabled mask length"),
    ]
    for make, match in bad:
        for m in (jp, tp):
            with pytest.raises(ValueError, match=match):
                make(m)
    with pytest.raises(ValueError, match="targets node 9"):
        tp.FaultPlan((tp.CrashStorm(targets=(9,)),)).compile_batch(SEEDS[:2], wl=t_raft())
    with pytest.raises(ValueError, match="same slot count|one slot count"):
        tp.stack_plan_rows([tp.FaultPlan((tp.Duplicate(),)).literalize(0),
                            tp.FaultPlan((tp.CrashStorm(targets=(1,), n=2),)).literalize(0)])
    p1 = tp.FaultPlan((tp.CrashStorm(targets=(1,), n=1),))
    assert p1.hash() != tp.FaultPlan((tp.CrashStorm(targets=(1,), n=2),)).hash()


def test_the_device_compile_waits_for_explore():
    """``compile_batch(device=True)``, the plan compile explore's device
    campaigns run on every uniform generation: for every spec kind, the
    mixed plan, a client army and a ``LiteralPlan``, the rows are torch
    tensors on the seeds' device, equal in value and dtype to the numpy
    path and to the JAX package's jnp path."""
    seeds_t = torch.from_numpy(SEEDS.view(np.int64).copy())
    army = {m: m.FaultPlan((m.ClientArmy(node=2, kind=11, n_ops=6, arg_hi=9, op_base=3),
                            m.CrashStorm(targets=(1, 2))), name="army")
            for m in (jp, tp)}
    cases = {**{k: (v, plans(jp)[k]) for k, v in plans(tp).items()},
             "army": (army[tp], army[jp])}
    for name, (plan, jplan) in cases.items():
        host = plan.compile_batch(SEEDS)
        for seeds in (seeds_t, SEEDS):
            dev = plan.compile_batch(seeds, device=True)
            for f in ROWS:
                got = getattr(dev, f)
                assert isinstance(got, torch.Tensor) and got.device.type == "cpu", (name, f)
                assert got.numpy().dtype == getattr(host, f).dtype, (name, f)
                np.testing.assert_array_equal(got.numpy(), getattr(host, f),
                                              err_msg=f"{name} {f}")
        if name in ("mixed", "army"):
            _same_rows(_as_numpy(plan.compile_batch(seeds_t, device=True)),
                       jplan.compile_batch(SEEDS, device=True))
    lit, jlit = plans(tp)["mixed"].literalize(7), plans(jp)["mixed"].literalize(7)
    dev = lit.compile_batch(seeds_t[:5], device=True)
    _same_rows(_as_numpy(dev), lit.compile_batch(SEEDS[:5]))
    _same_rows(_as_numpy(dev), jlit.compile_batch(SEEDS[:5], device=True))


def _as_numpy(rows):
    return tcore.PlanRows(**{f: getattr(rows, f).numpy() for f in ROWS})


def test_plan_threefry_is_the_engine_generator():
    """The numpy cipher of the plan compiler equals the engine's torch
    ``threefry2x32`` and the JAX package's scalar one."""
    rng = np.random.default_rng(0)
    k0, k1, x0, x1 = (rng.integers(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
                      for _ in range(4))
    a0, a1 = np_threefry2x32v(k0, k1, x0, x1)
    b0, b1 = threefry2x32(*(torch.from_numpy(v.astype(np.int64)) for v in (k0, k1, x0, x1)))
    np.testing.assert_array_equal(a0.astype(np.int64), b0.numpy())
    np.testing.assert_array_equal(a1.astype(np.int64), b1.numpy())
    for i in range(0, 256, 37):
        c0, c1 = j_threefry(k0[i], k1[i], x0[i], x1[i])
        assert (int(c0), int(c1)) == (int(a0[i]), int(a1[i]))


def test_slow_args_and_kind_names():
    for b, mult in ((3, 17), (-1, 9), (0, tcore.SLOW_MULT_MAX)):
        packed = tcore.pack_slow_arg(b, mult)
        assert packed == jp.pack_slow_arg(b, mult)
        assert tcore.unpack_slow_arg(packed) == (b, mult)
    arr = tcore.pack_slow_arg(np.array([1, -1]), np.array([4, 5]))
    np.testing.assert_array_equal(arr, jp.pack_slow_arg(np.array([1, -1]), np.array([4, 5])))
    t = tcore.pack_slow_arg(torch.tensor([2, -1], dtype=torch.int32), 7)
    assert t.tolist() == [jp.pack_slow_arg(2, 7), jp.pack_slow_arg(-1, 7)]
    for kind in range(256):
        assert tp.kind_name(kind) == jp.kind_name(kind)
