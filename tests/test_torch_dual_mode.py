"""The dual-mode contract on the port, held against the JAX package.

The same ``FaultPlan`` drives the batched engine (pool rows) and the
single-seed runtime (``chaos.Nemesis``), and ``check.Recorder`` records a
runtime application's history in the engine's representation:

* the JAX package's ``TestNemesisAsyncio`` cases, through both packages,
  with equal applied logs, wall-clock probes and ``NetSim`` state;
* the nemesis's events equal to the port's ``compile_batch`` rows, numpy
  and torch, for 64 seeds;
* every engine kind the nemesis applies, the disk-fault kinds and the
  every-node target ``-1`` included, with equal logs and state;
* ``tests/_torch_raft_kv.py`` against ``examples/raft_kv.py`` with and
  without a crash plan: equal ``Recorder`` rows and verdicts;
* the convergence of the engine's verdicts (the port's plain step on
  the CPU) and the port runtime's, without and with the crash plan.
"""

import _torch_threads  # noqa: F401
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import madsim_tpu as jms
import madsim_tpu.chaos  # noqa: F401
import madsim_tpu.check  # noqa: F401
import madsim_tpu_torch as tms
from _torch_dual import (
    election_verdict, event_tuples, nemesis_events, raft_cluster, rows_events,
)
from _torch_scenarios import mod, norm, run

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

import _torch_raft_kv  # noqa: E402
import raft_kv  # noqa: E402


def crash_plan(ms, n=2):
    c = ms.chaos
    return c.FaultPlan((c.CrashStorm(targets=(0, 1, 2, 3, 4), n=n),))


def mixed_plan(ms):
    c = ms.chaos
    return c.FaultPlan((
        c.CrashStorm(targets=(1, 2, 3, 4), n=1), c.PauseStorm(targets=(1, 2, 3, 4), n=1),
        c.Partition(targets=(0, 1, 2, 3)),
        c.Partition(targets=(0, 1, 2), asymmetric=True),
        c.Partition(targets=(1, 2, 3), partial_p=0.5),
        c.FlappingPartition(targets=(1, 2, 3), n_cycles=2, asymmetric=True),
        c.GrayFailure(targets=(0, 1, 2, 3, 4, 5), n_links=2), c.Duplicate(),
        c.ClockSkew(targets=(0, 1, 2, 3, 4, 5), n=2),
        c.DiskFault(targets=(1, 2), n_torn=1, n_sync_loss=1, n_eio=1),
    ), name="mixed")


# ------------------------------------------- TestNemesisAsyncio, both ways
def nemesis_applies_plan_events(ms):
    k = mod(ms, "engine.core")
    c = ms.chaos
    plan = c.LiteralPlan(events=(
        c.FaultEvent(t=50_000_000, kind=k.KIND_KILL, a0=1),
        c.FaultEvent(t=150_000_000, kind=k.KIND_RESTART, a0=1),
        c.FaultEvent(t=10_000_000, kind=k.KIND_SKEW, a0=0, a1=250_000_000),
        c.FaultEvent(t=20_000_000, kind=k.KIND_SLOW_LINK, a0=0, a1=k.pack_slow_arg(1, 8)),
        c.FaultEvent(t=30_000_000, kind=k.KIND_DUP_ON),
        c.FaultEvent(t=170_000_000, kind=k.KIND_DUP_OFF),
    ))
    rt = ms.Runtime(seed=7)
    n0 = rt.create_node().name("n0").build()
    n1 = rt.create_node().name("n1").build()
    SystemTime = mod(ms, "runtime.time_").SystemTime

    async def main():
        h = ms.Handle.current()
        nem = c.Nemesis(plan, nodes=[n0, n1])
        wall = []

        async def probe():
            base = h.time.base_unix_ns
            for _ in range(3):
                await ms.sleep(0.06)
                wall.append(SystemTime.now().unix_ns - base - ms.now_ns())

        p = n0.spawn(probe())
        applied = await nem.run()
        await p
        net = h.simulator(ms.NetSim)
        return [[(t, *event_tuples([e])[0]) for t, e in applied], wall,
                net.network.slow_mult(n0.id, n1.id), net.network.slow_mult(n1.id, n0.id),
                net._duplicate]

    rt.set_time_limit(2.0)
    return norm(rt.block_on(main()))


def default_mapping_targets_created_nodes(ms):
    k = mod(ms, "engine.core")
    plan = ms.chaos.LiteralPlan(events=(ms.chaos.FaultEvent(t=1_000_000, kind=k.KIND_KILL, a0=0),))
    rt = ms.Runtime(seed=2)
    n0 = rt.create_node().name("victim").build()

    async def main():
        info = ms.Handle.current().executor.nodes[n0.id]
        log = await ms.chaos.Nemesis(plan).run()
        return [info.killed, [(t, *event_tuples([e])[0]) for t, e in log]]

    return norm(rt.block_on(main()))


def default_mapping_rejects_out_of_range_target(ms):
    k = mod(ms, "engine.core")
    plan = ms.chaos.LiteralPlan(events=(ms.chaos.FaultEvent(t=1_000, kind=k.KIND_KILL, a0=3),))
    rt = ms.Runtime(seed=2)
    rt.create_node().build()

    async def main():
        await ms.chaos.Nemesis(plan).run()

    try:
        rt.block_on(main())
        return "no-error"
    except ValueError as e:
        return norm(e)


def same_trajectory_as_engine_compile(ms):
    plan = ms.chaos.FaultPlan((ms.chaos.CrashStorm(targets=(0, 1), n=2),))
    rt = ms.Runtime(seed=11)
    rt.create_node().build()
    rt.create_node().build()

    async def main():
        return ms.chaos.Nemesis(plan, nodes=[1, 2]).events()

    events = rt.block_on(main())
    assert events == sorted(plan.compile(11), key=lambda e: e.t)
    return event_tuples(events)


def node_wide_slow_overwrites_like_the_engine(ms):
    rt = ms.Runtime(seed=1)
    a = rt.create_node().build()
    b = rt.create_node().build()

    async def main():
        net = ms.Handle.current().simulator(ms.NetSim)
        net.slow_link(a, b, 4)
        out = [net.network.slow_mult(a.id, b.id)]
        net.slow_node(a, 8)
        out.append(net.network.slow_mult(a.id, b.id))
        net.slow_node(a, 1)
        out.append(net.network.slow_mult(a.id, b.id))
        return out

    return rt.block_on(main())


def duplication_duplicates_datagrams(ms):
    rt = ms.Runtime(seed=3)
    a = rt.create_node().name("a").ip("10.0.0.1").build()
    b = rt.create_node().name("b").ip("10.0.0.2").build()

    async def main():
        h = ms.Handle.current()
        got = []

        async def server():
            ep = await ms.Endpoint.bind("0.0.0.0:700")
            while True:
                msg, _ = await ep.recv_from(1)
                got.append((msg, ms.now_ns()))

        async def client():
            ep = await ms.Endpoint.bind("0.0.0.0:0")
            h.simulator(ms.NetSim).set_duplicate(True)
            await ep.send_to("10.0.0.2:700", 1, "x")
            await ms.sleep(0.5)
            h.simulator(ms.NetSim).set_duplicate(False)
            await ep.send_to("10.0.0.2:700", 1, "y")
            await ms.sleep(0.5)

        b.spawn(server())
        await a.spawn(client())
        return got

    rt.set_time_limit(5.0)
    return norm(rt.block_on(main()))


NEMESIS_CASES = {f.__name__: f for f in (
    nemesis_applies_plan_events, default_mapping_targets_created_nodes,
    default_mapping_rejects_out_of_range_target, same_trajectory_as_engine_compile,
    node_wide_slow_overwrites_like_the_engine, duplication_duplicates_datagrams,
)}


@pytest.mark.parametrize("name", sorted(NEMESIS_CASES))
def test_nemesis_case_matches_the_jax_package(name):
    f = NEMESIS_CASES[name]
    got = f(tms)
    assert got == f(jms)
    if name == "nemesis_applies_plan_events":
        applied, wall = got[0], got[1]
        assert [e[2] for e in applied] == [248, 244, 246, 0, 1, 247]
        assert wall == [250_000_000] * 3 and got[2:] == [8, 8, False]
    if name == "duplication_duplicates_datagrams":
        msgs = [m for m, _t in got]
        assert msgs.count("x") == 2 and msgs.count("y") == 1


# -------------------------------------------- events against compile_batch
@pytest.mark.parametrize("plan_name,n_nodes", [("crash", 5), ("mixed", 6)])
def test_nemesis_events_equal_compile_batch_rows(plan_name, n_nodes):
    plan = crash_plan(tms) if plan_name == "crash" else mixed_plan(tms)
    jplan = crash_plan(jms) if plan_name == "crash" else mixed_plan(jms)
    seeds = np.arange(1, 65, dtype=np.uint64)
    host = plan.compile_batch(seeds)
    dev = plan.compile_batch(torch.as_tensor(seeds.astype(np.int64)), device=True)
    for s, seed in enumerate(seeds.tolist()):
        want = nemesis_events(tms, plan, seed, n_nodes)
        assert want == rows_events(host, s) == rows_events(dev, s)
        assert want == event_tuples(sorted(plan.compile(seed), key=lambda e: e.t))
        if s < 8:
            assert want == nemesis_events(jms, jplan, seed, n_nodes)


# ----------------------------------------------------- every applied kind
def every_kind(ms):
    """Every engine kind the nemesis applies, in one literal plan, with
    the runtime's chaos state sampled between events."""
    k = mod(ms, "engine.core")
    c = ms.chaos
    ev = [
        (k.KIND_PAUSE, 1, 0), (k.KIND_RESUME, 1, 0), (k.KIND_CLOG, 0, 2),
        (k.KIND_UNCLOG, 0, 2), (k.KIND_CLOG_NODE, 3, 0), (k.KIND_UNCLOG_NODE, 3, 0),
        (k.KIND_CLOG_1W, 2, 1), (k.KIND_UNCLOG_1W, 2, 1),
        (k.KIND_SLOW_LINK, 0, k.pack_slow_arg(1, 6)), (k.KIND_SLOW_LINK, 2, k.pack_slow_arg(-1, 3)),
        (k.KIND_UNSLOW, 2, k.pack_slow_arg(-1, 1)), (k.KIND_UNSLOW, 0, k.pack_slow_arg(1, 1)),
        (k.KIND_DUP_ON, 0, 0), (k.KIND_DUP_OFF, 0, 0), (k.KIND_SKEW, 3, -40_000_000),
        (k.KIND_SYNC_LOSS, 1, 0), (k.KIND_SYNC_LOSS, -1, 1), (k.KIND_SYNC_OK, -1, 0),
        (k.KIND_TORN_ON, -1, 0), (k.KIND_TORN_OFF, 2, 0), (k.KIND_SYNC_LOSS, 3, 1),
        (k.KIND_SYNC_OK, 3, 0), (k.KIND_KILL, 2, 0), (k.KIND_RESTART, 2, 0),
    ]
    plan = c.LiteralPlan(events=tuple(
        c.FaultEvent(t=10_000_000 * (i + 1), kind=kind, a0=a0, a1=a1)
        for i, (kind, a0, a1) in enumerate(ev)))
    rt = ms.Runtime(seed=5)
    nodes = [rt.create_node().name(f"n{i}").ip(f"10.0.0.{i + 1}").build() for i in range(4)]

    def state(h):
        net = h.simulator(ms.NetSim).network
        fs = h.simulator(ms.FsSim)
        ids = [n.id for n in nodes]
        ex = h.executor
        return [
            sorted(net._clogged_nodes), sorted(net._clogged_links), sorted(net._slow_links.items()),
            h.simulator(ms.NetSim)._duplicate, sorted(fs._torn), sorted(fs._sync_loss),
            sorted(fs._fail_writes), [h.time.skew_of(i) for i in ids],
            [(ex.nodes[i].killed, ex.nodes[i].paused) for i in ids],
        ]

    async def main():
        h = ms.Handle.current()
        samples = []

        async def probe():
            await ms.sleep(0.005)
            for _ in range(len(ev)):
                await ms.sleep(0.01)
                samples.append(state(h))

        p = ms.spawn(probe())
        log = await c.Nemesis(plan).run()
        await p
        return [[(t, *event_tuples([e])[0]) for t, e in log], samples]

    return norm(rt.block_on(main()))


def test_every_applied_kind_matches_the_jax_package():
    got = every_kind(tms)
    assert got == every_kind(jms)
    applied, samples = got
    assert len(applied) == 24
    # -1 = every node for the disk kinds
    assert samples[16][5] == [2] and samples[16][6] == [1, 2, 3, 4]
    assert samples[17][5] == samples[17][6] == []
    assert samples[18][4] == [1, 2, 3, 4] and samples[19][4] == [1, 2, 4]


def test_nemesis_refuses_user_kinds_as_the_jax_package_does():
    def attempt(ms, kind):
        plan = ms.chaos.LiteralPlan(events=(ms.chaos.FaultEvent(t=1_000, kind=kind, a0=0),))

        async def main():
            ms.Handle.current().create_node().build()
            await ms.chaos.Nemesis(plan).run()

        return run(ms, 1, main)

    for kind in (10, 12, 243, 6):
        got = attempt(tms, kind)
        assert got == attempt(jms, kind)
        assert got[1] == "ValueError"


# ---------------------------------------------- the raft KV application
@pytest.mark.parametrize("plan", [False, True], ids=["no-plan", "crash-plan"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_raft_kv_copy_records_the_example_s_history(seed, plan):
    a = raft_cluster(jms, raft_kv, seed, crash_plan(jms) if plan else None, client=True)
    b = raft_cluster(tms, _torch_raft_kv, seed, crash_plan(tms) if plan else None, client=True)
    assert b["elect_rows"] == a["elect_rows"] and b["elect_rows"]
    assert b["kv_rows"] == a["kv_rows"] and len(b["kv_rows"]) == 16
    assert b["log"] == a["log"] and b["events"] == a["events"]
    assert len(b["log"]) == (4 if plan else 0)
    ja, tb = a["kv"].check_kv(), b["kv"].check_kv()
    assert (tb.ok, tb.n_ops) == (ja.ok, ja.n_ops) == (True, 8)
    assert election_verdict(tms, b["elect"]) == election_verdict(jms, a["elect"]) is True


# ----------------------------------------------------------- convergence
def _engine_verdicts(seeds, plan=None, pool=48):
    from madsim_tpu_torch.check import election_safety
    from madsim_tpu_torch.engine import EngineConfig, search_seeds
    from madsim_tpu_torch.models import make_raft
    from madsim_tpu_torch.models.raft import OP_ELECT

    box = {}

    def inv(h):
        box["ok"] = election_safety(h, elect_op=OP_ELECT)
        return box["ok"]

    rep = search_seeds(
        make_raft(record=True), EngineConfig(pool_size=pool, loss_p=0.02), None,
        n_seeds=len(seeds), seed_base=seeds[0], max_steps=600, history_invariant=inv,
        plan=plan, device="cpu",
    )
    assert rep.unhalted_seeds.size == 0 and not rep.overflowed.any()
    return [bool(v) for v in box["ok"]]


def test_raft_verdicts_converge_across_modes():
    """``test_chaos.py``'s convergence on the port: the engine's recorded
    election history (the plain step on the CPU) and the port runtime's
    ``Recorder`` history give the same election-safety verdicts."""
    seeds = [1, 2, 3]
    engine = _engine_verdicts(seeds)
    runtime = []
    for seed in seeds:
        out = raft_cluster(tms, _torch_raft_kv, seed, persist=False)
        assert len(out["elect"]) > 0, "the cluster must elect at least once"
        runtime.append(election_verdict(tms, out["elect"]))
    assert engine == runtime == [True] * len(seeds)


def test_raft_verdicts_converge_under_the_crash_plan():
    """Phase 70 of ``chip_smoke.py`` at 16 seeds on the CPU: the plan's
    rows in the engine (raft-record, pool 64) and its nemesis on the
    runtime; equal verdicts, every seed electing, each nemesis log its
    seed's compiled events."""
    plan = crash_plan(tms)
    seeds = list(range(1, 17))
    engine = _engine_verdicts(seeds, plan=plan, pool=64)
    rows = plan.compile_batch(np.asarray(seeds, np.uint64))
    runtime = []
    for s, seed in enumerate(seeds):
        out = raft_cluster(tms, _torch_raft_kv, seed, plan)
        assert len(out["elect"]) > 0
        assert [e[1:] for e in out["log"]] == out["events"] == rows_events(rows, s)
        runtime.append(election_verdict(tms, out["elect"]))
    assert engine == runtime == [True] * len(seeds)
