"""The port's single-seed runtime against the JAX package's.

Each scenario of ``_torch_scenarios.RUNTIME`` (the executor, virtual
time, the seeded RNG, node chaos, the builder's environment, the stdlib
and raw-asyncio interposition, plugins, tracing, the public surface) runs
on both packages at seeds 0, 1 and 7 and must give an equal log. Besides:
both packages' interposition layers in one process, under both install
orders; the context of one package refusing the other's runtime; and the
one ``DeterminismError`` class of the port.
"""

import _torch_threads  # noqa: F401
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import madsim_tpu as jms
import madsim_tpu.chaos  # noqa: F401
import madsim_tpu.check  # noqa: F401
import madsim_tpu_torch as tms
from _torch_scenarios import KILL_TIMED, NET, RUNTIME

ROOT = Path(__file__).resolve().parent.parent
SEEDS = (0, 1, 7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(RUNTIME))
def test_scenario_matches_the_jax_package(name, seed):
    f = RUNTIME[name]
    assert f(tms, seed) == f(jms, seed)


# one program, run alternately on both packages in a fresh process
_ALTERNATE = r"""
import json, os, random, sys, threading, time
order = sys.argv[1]
if order == "jax-first":
    import madsim_tpu as J
    import madsim_tpu_torch as P
else:
    import madsim_tpu_torch as P
    import madsim_tpu as J


def outside():
    random.seed(123)
    a = random.random()
    random.seed(123)
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    return [a == random.random(), time.time() > 1.7e9, os.urandom(8) != os.urandom(8)]


def sim(ms, seed, stdlib):
    async def main():
        h = ms.Handle.current()
        if stdlib:
            draws = [random.random(), random.getrandbits(32), os.urandom(4).hex()]
            clock = [time.time(), time.monotonic_ns()]
        else:
            rng = h.rng
            draws = [rng._rng.random(), rng._rng.getrandbits(32), rng.randbytes(4).hex()]
            clock = [(h.time.base_unix_ns + h.time.now_ns()) / 1e9, h.time.now_ns()]
        await ms.sleep(0.5)
        return draws + clock + [ms.now_ns()]

    return ms.Runtime(seed=seed).block_on(main())


out = {"outside": [outside()]}
for rnd in range(2):
    for name, ms in (("jax", J), ("port", P)):
        for seed in (3, 4):
            out.setdefault(f"{name}-{seed}", []).append(
                [sim(ms, seed, True), sim(ms, seed, False)])
    out["outside"].append(outside())
print(json.dumps(out))
"""


@pytest.mark.parametrize("order", ["jax-first", "port-first"])
def test_both_interposition_layers_in_one_process(order):
    """Whichever package installs its dispatchers first, a simulation of
    either package is served by its own RNG and clock, and code outside
    both reaches the real ``random``, ``time``, ``os.urandom`` and
    threads."""
    got = subprocess.run(
        [sys.executable, "-c", _ALTERNATE, order], cwd=ROOT, capture_output=True,
        text=True, check=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu"),
    )
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["outside"] == [[True, True, True]] * 3
    for seed in (3, 4):
        jax_runs, port_runs = out[f"jax-{seed}"], out[f"port-{seed}"]
        # the stdlib calls are the package's own stream and clock
        for stdlib, direct in jax_runs + port_runs:
            assert stdlib == direct
        # the same seed gives the same values in both packages, every time
        assert jax_runs[0] == jax_runs[1] == port_runs[0] == port_runs[1]
    assert out["jax-3"] != out["jax-4"]


def test_one_package_refuses_the_others_runtime():
    """The port's context is its own: a port ``Nemesis``, ``Recorder`` or
    free function used inside a JAX ``Runtime`` raises, and so does the
    JAX package's inside a port ``Runtime``."""
    plan = tms.chaos.LiteralPlan(events=(tms.chaos.FaultEvent(t=1, kind=0, a0=0),))
    jplan = jms.chaos.LiteralPlan(events=(jms.chaos.FaultEvent(t=1, kind=0, a0=0),))

    def attempts(other, nemesis, recorder):
        out = []
        for call in (
            lambda: nemesis.events(),
            lambda: recorder.invoke(client=0, op=1, key=0, arg=1),
            lambda: other.now_ns(),
            lambda: other.spawn(other.sleep(1.0)),
        ):
            try:
                call()
                out.append("no-error")
            except RuntimeError as e:
                out.append(str(e))
        return out

    async def in_jax():
        jms.Handle.current().create_node().build()
        return attempts(tms, tms.chaos.Nemesis(plan), tms.check.Recorder())

    async def in_port():
        tms.Handle.current().create_node().build()
        return attempts(jms, jms.chaos.Nemesis(jplan), jms.check.Recorder())

    for ms, main, other in ((jms, in_jax, "madsim_tpu_torch"), (tms, in_port, "madsim_tpu")):
        got = ms.Runtime(seed=1).block_on(main())
        assert got == [
            "there is no simulation context on this thread; this API must be "
            f"called from within a {other} Runtime"
        ] * 4


def test_the_port_has_one_determinism_error():
    from madsim_tpu_torch.engine import core as tcore
    from madsim_tpu_torch.engine import verify
    from madsim_tpu_torch.runtime import rand

    assert tms.DeterminismError is verify.DeterminismError is rand.DeterminismError
    assert tms.engine.DeterminismError is tms.DeterminismError
    assert tms.DeterminismError is not jms.DeterminismError

    calls = [0]

    def on_init(ctx):
        calls[0] += 1  # state outside the simulation
        em = ctx.emits()
        em.after(1000 * calls[0], tcore.user_kind(1), ctx.node)
        return ctx.state, em.build()

    def tick(ctx):
        em = ctx.emits()
        em.halt()
        return ctx.state, em.build()

    wl = tcore.Workload(name="flaky", n_nodes=2, state_width=1,
                        handlers=(on_init, tick), max_emits=2, args_words=2)
    try:
        verify.check_determinism(wl, tcore.EngineConfig(pool_size=8), [0, 1], 6,
                                 device="cpu")
        raise AssertionError("the divergence went unseen")
    except tms.DeterminismError as e:
        assert "flaky x2: seed index 0" in str(e)

    # the runtime's own checker raises the same class
    state = {"runs": 0}

    async def leaky():
        state["runs"] += 1
        await tms.sleep(float(state["runs"]))
        tms.thread_rng().random_float()

    with pytest.raises(verify.DeterminismError, match="non-determinism detected"):
        tms.Runtime.check_determinism(seed=17, workload=leaky)


@pytest.mark.parametrize("name", KILL_TIMED)
def test_a_kill_closes_pipes_in_registration_order(name):
    """The port's ``NetSim.reset_node`` closes a killed node's pipes in
    the order they were registered, so the time a peer sees the EOF is
    the seed's, whatever the objects' addresses: the same seed gives the
    same log with the heap laid out differently between runs."""
    f = NET[name]
    logs = []
    ballast = []
    for i in range(4):
        ballast.append([object() for _ in range(97 * i + 1)])
        logs.append(f(tms, 5, timed=True))
    assert all(log == logs[0] for log in logs)
    assert "after-kill" not in json.dumps(logs[0])
