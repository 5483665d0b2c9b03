"""shardkv's planted non-idempotent put (``bug="noidem"``) under the
retry soak's policy, in the torch port against the JAX package, as the
JAX package's ``tests/test_retry.py`` holds it: on the clean army and
the mutant the attempt-aware ``exactly_once`` gives the JAX verdicts on
the host and as a device screen while the final-state
``shard_coverage`` sees nothing; a 32-seed hunt flags the JAX package's
seeds with its traces, the first one shrinks to the JAX package's
events, rounds, probes and trace under the plan's own ``RetrySpec``, and
the shrunk plan replays twice to that trace and the violation. Exact
equality."""

import _torch_threads  # noqa: F401
import dataclasses

import numpy as np
import pytest
import torch

import madsim_tpu.chaos as jchaos
import madsim_tpu.engine as je
from madsim_tpu import check as jcheck
from madsim_tpu.models import shardkv as jsk
from madsim_tpu_torch import chaos as tchaos
from madsim_tpu_torch import check as tcheck
from madsim_tpu_torch.check import device as tdevice
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.search import search_seeds
from madsim_tpu_torch.models import shardkv as tsk

from _torch_retry import SK_CFG_KW, SK_MAKE, N_OPS, sk_plan

STEPS = 3000


def _hunt(port: bool, bug, n_seeds: int):
    """``search_seeds`` of the shardkv army (``bug``) under the soak's
    policied plan, judged by exactly_once; returns the report and the
    histories the invariant saw."""
    mod, eng, chk = (tsk, tcore, tcheck) if port else (jsk, je, jcheck)
    wl = mod.make_shardkv(bug=bug, **SK_MAKE)
    box = {}

    def inv(h):
        box["h"] = h
        return chk.exactly_once(h, mod.OP_ARMY_PUT)

    search = search_seeds if port else je.search_seeds
    kw = dict(device="cpu") if port else {}
    rep = search(wl, eng.EngineConfig(**SK_CFG_KW), None, n_seeds=n_seeds, max_steps=STEPS,
                 plan=sk_plan(port), history_invariant=inv,
                 latency=eng.LatencySpec(ops=N_OPS), require_halt=False, **kw)
    return wl, rep, box["h"]


@pytest.fixture(scope="module")
def hunts():
    """The noidem hunt at 32 seeds and the clean army at 8, both packages:
    ``{bug: (JAX (wl, report, histories), port (...))}``."""
    return {bug: (_hunt(False, bug, n), _hunt(True, bug, n))
            for bug, n in (("noidem", 32), (False, 8))}


def test_the_noidem_workload_is_the_reference():
    jwl = jsk.make_shardkv(bug="noidem", **SK_MAKE)
    twl = tsk.make_shardkv(bug="noidem", **SK_MAKE)
    assert (twl.name, twl.n_nodes, twl.state_width, len(twl.handlers)) == (
        jwl.name, jwl.n_nodes, jwl.state_width, len(jwl.handlers)) == (
        "shardkv-noidem-army", 14, 17, 18)
    assert dict(twl.model_params)["bug"] == "noidem"
    with pytest.raises(ValueError, match="requires army=True"):
        tsk.make_shardkv(record=True, bug="noidem")


@pytest.mark.parametrize("bug", ["noidem", "clean"])
def test_exactly_once_on_real_batches(hunts, bug):
    """The clean guard dedups every re-delivered attempt; noidem applies
    them all, and only exactly_once sees it: the host and device verdicts
    are the JAX package's, shard_coverage passes both ways."""
    (_jwl, jrep, jh), (_twl, trep, th) = hunts["noidem" if bug == "noidem" else False]
    np.testing.assert_array_equal(trep.traces, np.asarray(jrep.traces))
    v_np = tcheck.exactly_once(th, tsk.OP_ARMY_PUT)
    np.testing.assert_array_equal(v_np, jcheck.exactly_once(jh, jsk.OP_ARMY_PUT))
    cols = [torch.as_tensor(np.asarray(x)) for x in (th.word, th.t, th.count, th.drop)]
    v_dev = tdevice.screen_ok((tdevice.exactly_once(tsk.OP_ARMY_PUT),), *cols)
    np.testing.assert_array_equal(v_dev.numpy(), v_np)
    assert np.asarray(tcheck.shard_coverage(th, tsk.OP_SHARD_OWN, tsk.OP_SHARD_WRITE)).all()
    assert v_np.all() if bug == "clean" else not v_np.all()


def test_noidem_found_shrunk_replayed(hunts):
    """The hunt flags the JAX package's seeds; the first shrinks under the
    plan's own policy to the JAX package's events, rounds, probes and
    trace; the shrunk literal plan (which carries no policy) replays twice
    with the campaign's spec to that trace and the violation."""
    (jwl, jrep, _jh), (twl, trep, _th) = hunts["noidem"]
    np.testing.assert_array_equal(trep.failing_seeds, jrep.failing_seeds)
    assert len(trep.failing_seeds) > 0
    seed = int(trep.failing_seeds[0])
    rt = sk_plan(True).retry_spec()

    def hinv_t(h):
        return tcheck.exactly_once(h, tsk.OP_ARMY_PUT)

    res = tchaos.shrink_plan(twl, tcore.EngineConfig(**SK_CFG_KW), seed, sk_plan(True),
                             history_invariant=hinv_t, max_steps=STEPS,
                             latency=tcore.LatencySpec(ops=N_OPS), device="cpu")
    want = jchaos.shrink_plan(jwl, je.EngineConfig(**SK_CFG_KW), seed, sk_plan(False),
                              history_invariant=lambda h: jcheck.exactly_once(h, jsk.OP_ARMY_PUT),
                              max_steps=STEPS, latency=je.LatencySpec(ops=N_OPS))
    assert [dataclasses.astuple(e) for e in res.events] == [
        dataclasses.astuple(e) for e in want.events]
    assert (res.rounds, res.tested, res.trace) == (want.rounds, want.tested, want.trace)
    assert len(res.events) < len(sk_plan(True).compile(seed))
    for _ in range(2):
        rep = search_seeds(twl, tcore.EngineConfig(**SK_CFG_KW), None,
                           seeds=np.asarray([seed], np.uint64), max_steps=STEPS, plan=res.plan,
                           history_invariant=hinv_t, latency=tcore.LatencySpec(ops=N_OPS),
                           require_halt=False, retry=rt, device="cpu")
        assert not bool(rep.ok[0]) and int(rep.traces[0]) == res.trace
