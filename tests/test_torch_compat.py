"""The port's asyncio compat shim against the JAX package's.

Each scenario of ``_torch_scenarios_services.COMPAT`` (after
``tests/test_compat_asyncio.py``) runs on both packages at seeds 0, 1
and 7 and must give an equal log that ends in a result. Besides: outside
a simulation the shim is the real asyncio; ``install()`` and
``uninstall()``; and both packages' shims in one process, installed in
either order, each in a fresh process: each shim dispatches on its own
package's context only, and outside both reaches the real asyncio.
"""

import _torch_threads  # noqa: F401
import asyncio as real_asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import madsim_tpu as jms
import madsim_tpu_torch as tms
from _torch_scenarios_services import COMPAT
from madsim_tpu_torch import compat
from madsim_tpu_torch.compat import asyncio as aio

ROOT = Path(__file__).resolve().parent.parent
SEEDS = (0, 1, 7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(COMPAT))
def test_scenario_matches_the_jax_package(name, seed):
    f = COMPAT[name]
    got = f(tms, seed)
    assert got == f(jms, seed)
    assert got[0] == "ok", got


def test_outside_sim_delegates_to_real_asyncio():
    async def main():
        await aio.sleep(0)
        t = aio.create_task(aio.sleep(0, "x"))
        return await t

    assert real_asyncio.run(main()) == "x"
    assert isinstance(aio.Queue(), real_asyncio.Queue)
    assert isinstance(aio.Lock(), real_asyncio.Lock)
    assert aio._real is real_asyncio
    # what the shim does not simulate is the real module's
    assert aio.Future is real_asyncio.Future


def test_install_uninstall():
    compat.install()
    try:
        import asyncio

        assert asyncio is aio
    finally:
        compat.uninstall()
    import asyncio

    assert asyncio is real_asyncio


_BOTH = r"""
import asyncio as REAL
import json, sys
order = sys.argv[1]
if order == "jax-first":
    # the port's shim is first imported while the JAX package's stands
    # under the name asyncio
    import madsim_tpu as J
    from madsim_tpu import compat as JC
    JC.install()
    import madsim_tpu_torch as P
    from madsim_tpu_torch import compat as PC
    PC.install()
else:
    import madsim_tpu_torch as P
    from madsim_tpu_torch import compat as PC
    import madsim_tpu as J
    from madsim_tpu import compat as JC
    PC.install()
    JC.install()
JA, PA = JC.asyncio, PC.asyncio
last = JA if order == "port-first" else PA


def kinds():
    # each shim's Lock, Queue and task: a simulated one inside its own
    # package's simulation, the real asyncio's elsewhere
    out = []
    for shim in (JA, PA):
        out.append([type(shim.Lock()).__module__, type(shim.Event()).__module__,
                    type(shim.Queue()).__module__])
    return out


def sim(ms):
    async def main():
        t0 = ms.now_ns()
        k = kinds()
        for shim in (JA, PA):
            await shim.sleep(0.5)
        import asyncio
        await asyncio.sleep(0.5)
        return [k, ms.now_ns() - t0 >= 1.5e9, asyncio is last]

    return ms.Runtime(seed=3).block_on(main())


async def outside():
    out = kinds()
    for shim in (JA, PA):
        await shim.sleep(0)
        out.append(await shim.create_task(shim.sleep(0, "real")))
    return out


res = {"jax": sim(J), "port": sim(P), "outside": REAL.run(outside()),
       "real": [PA._real.__name__, PA._real.Lock is REAL.Lock, PA._real.run is REAL.run]}
(JC if order == "port-first" else PC).uninstall()
(PC if order == "port-first" else JC).uninstall()
import asyncio
res["restored"] = asyncio is REAL
print(json.dumps(res))
"""


@pytest.mark.parametrize("order", ["jax-first", "port-first"])
def test_both_shims_in_one_process(order):
    """Whichever package installs its shim first (and whether the port's
    is imported under the other's), each shim serves its own package's
    simulation, treats the other's as the outside world (the real
    asyncio), and the last uninstall restores the real module."""
    got = subprocess.run(
        [sys.executable, "-c", _BOTH, order], cwd=ROOT, capture_output=True, text=True,
        check=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT),
                                          JAX_PLATFORMS="cpu"),
    )
    out = json.loads(got.stdout.strip().splitlines()[-1])
    real = ["asyncio.locks", "asyncio.locks", "asyncio.queues"]
    jax_sim = ["madsim_tpu.compat.asyncio"] * 3
    port_sim = ["madsim_tpu_torch.compat.asyncio"] * 3
    assert out["jax"] == [[jax_sim, real], True, True]
    assert out["port"] == [[real, port_sim], True, True]
    assert out["outside"] == [real, real, "real", "real"]
    assert out["real"] == ["asyncio", True, True]
    assert out["restored"] is True


def test_the_port_finds_the_real_asyncio_under_another_shim():
    """Imported while another package's shim stands in ``sys.modules``,
    the port's shim still binds the standard library's asyncio, whose
    names are the loaded module's objects."""
    code = (
        "import sys, asyncio as REAL\n"
        "from madsim_tpu import compat as JC\n"
        "JC.install()\n"
        "from madsim_tpu_torch.compat import asyncio as PA\n"
        "assert sys.modules['asyncio'] is JC.asyncio\n"
        "print(PA._real is not JC.asyncio, PA._real.__name__, PA._real.Lock is REAL.Lock,"
        " PA._real.sleep is REAL.sleep, PA.CancelledError is REAL.CancelledError)\n"
    )
    got = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu"),
    )
    assert got.stdout.split() == ["True", "asyncio", "True", "True", "True"]
