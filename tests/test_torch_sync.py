"""The port's ``sync`` (oneshot, mpsc, watch, broadcast, ``Mutex``,
``RwLock``, ``Semaphore``, ``Notify``, ``Barrier``) against the JAX
package's: each scenario of ``_torch_scenarios_services.SYNC`` (after
``tests/test_sync.py``) runs on both packages at seeds 0, 1 and 7 and
must give an equal log that ends in a result."""

import _torch_threads  # noqa: F401

import pytest

import madsim_tpu as jms
import madsim_tpu_torch as tms
from _torch_scenarios_services import SYNC

SEEDS = (0, 1, 7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SYNC))
def test_scenario_matches_the_jax_package(name, seed):
    f = SYNC[name]
    got = f(tms, seed)
    assert got == f(jms, seed)
    assert got[0] == "ok", got


def test_the_package_carries_sync():
    """``import madsim_tpu_torch`` loads ``sync``, as the JAX package's
    ``__init__`` does, with the same public names."""
    assert tms.sync.__name__ == "madsim_tpu_torch.sync"
    public = {n for n in dir(jms.sync) if not n.startswith("_")}
    assert {n for n in dir(tms.sync) if not n.startswith("_")} == public
