"""The port's simulated network against the JAX package's.

Each scenario of ``_torch_scenarios.NET`` (endpoints and tags,
connections, partitions and directional clogs, loss and latency, send
and RPC hooks, RPC and ``@service``, gray failures and duplication, TCP,
UDP, Unix sockets, asyncio streams and datagram endpoints over the
simulated network) runs on both packages at seeds 0, 1 and 7 and must
give an equal log.
"""

import _torch_threads  # noqa: F401

import pytest

import madsim_tpu as jms
import madsim_tpu_torch as tms
from _torch_scenarios import NET

SEEDS = (0, 1, 7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(NET))
def test_scenario_matches_the_jax_package(name, seed):
    f = NET[name]
    assert f(tms, seed) == f(jms, seed)


def test_every_runtime_has_the_port_simulators():
    rt = tms.Runtime(seed=1)
    assert isinstance(rt.handle.simulator(tms.NetSim), tms.net.NetSim)
    assert isinstance(rt.handle.simulator(tms.FsSim), tms.fs.FsSim)
    assert [c.__module__ for c in tms.runtime.DEFAULT_SIMULATORS] == [
        "madsim_tpu_torch.fs", "madsim_tpu_torch.net.netsim",
    ]
