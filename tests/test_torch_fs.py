"""The port's simulated filesystem against the JAX package's.

Each scenario of ``_torch_scenarios.FS`` (reads, writes and metadata,
per-node namespaces, power failure back to the last sync, torn writes,
sync loss and write errors, a node's restart reloading its synced state)
runs on both packages at seeds 0, 1 and 7 and must give an equal log.
"""

import _torch_threads  # noqa: F401

import pytest

import madsim_tpu as jms
import madsim_tpu_torch as tms
from _torch_scenarios import FS

SEEDS = (0, 1, 7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(FS))
def test_scenario_matches_the_jax_package(name, seed):
    f = FS[name]
    assert f(tms, seed) == f(jms, seed)
