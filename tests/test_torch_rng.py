"""madsim_tpu_torch/engine/rng.py against the JAX package's generator.

threefry2x32 on random and edge words against the numpy mirror and the
C++ oracle; the purpose registry, the draw helpers and the bounded
reductions against the JAX Draw, exactly (integer arithmetic).
"""

import _torch_threads  # noqa: F401
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from madsim_tpu.engine import rng as jrng
from madsim_tpu_torch.engine import rng as trng

EDGE = np.array(
    [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1, 0x1BD11BDA, 0xDEADBEEF],
    dtype=np.uint32,
)


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def test_threefry_matches_numpy_mirror_on_random_and_edge_words():
    n = 4096
    cols = [_words(n, s) for s in range(4)]
    # every combination of edge words in every position
    grid = np.stack(np.meshgrid(EDGE, EDGE, EDGE, EDGE, indexing="ij")).reshape(4, -1)
    k0, k1, x0, x1 = (np.concatenate([c, g]) for c, g in zip(cols, grid))
    want0, want1 = jrng.np_threefry2x32v(k0, k1, x0, x1)
    got0, got1 = trng.threefry2x32(_t(k0), _t(k1), _t(x0), _t(x1))
    np.testing.assert_array_equal(got0.numpy(), want0.astype(np.int64))
    np.testing.assert_array_equal(got1.numpy(), want1.astype(np.int64))
    assert int(got0.min()) >= 0 and int(got0.max()) < 2**32


@pytest.mark.skipif(
    shutil.which("make") is None or shutil.which("g++") is None,
    reason="native toolchain unavailable",
)
def test_threefry_matches_cpp_oracle():
    from madsim_tpu.engine.oracle import oracle_threefry

    rows = list(zip(*(_words(24, 10 + s) for s in range(4))))
    rows += [(int(e), int(EDGE[-1 - j]), int(EDGE[j]), int(e)) for j, e in enumerate(EDGE)]
    for k0, k1, x0, x1 in rows:
        got = trng.threefry2x32(int(k0), int(k1), int(x0), int(x1))
        assert (int(got[0]), int(got[1])) == oracle_threefry(
            int(k0), int(k1), int(x0), int(x1)
        )


def test_purpose_registry_equals_reference():
    assert [dataclasses.astuple(x) for x in trng.PURPOSE_LANES] == [
        dataclasses.astuple(x) for x in jrng.PURPOSE_LANES
    ]
    for name in (
        "DRAW_SPAN_MAX", "PURPOSE_POLL_COST", "PURPOSE_CLOG_JITTER",
        "PURPOSE_TORN", "PURPOSE_RETRY", "PURPOSE_LATENCY", "PURPOSE_DUP",
        "PURPOSE_LOSS", "PURPOSE_USER", "PURPOSE_PLAN", "PURPOSE_EXPLORE",
        "PURPOSE_CLIENT", "PURPOSE_FARM",
    ):
        assert getattr(trng, name) == getattr(jrng, name), name
    assert trng._ROTATIONS == jrng._ROTATIONS
    assert trng._PARITY == int(jrng._PARITY)


@pytest.mark.parametrize("p", [0.0, 1e-9, 0.02, 0.5, 0.999999, 1.0, 2.0, -1.0])
def test_chance_threshold_equals_reference(p):
    assert trng.chance_threshold(p) == jrng.chance_threshold(p)


def test_draw_helpers_equal_reference_draw():
    rs = np.random.default_rng(3)
    seeds = np.concatenate([
        rs.integers(0, 2**63, size=200, dtype=np.uint64) * np.uint64(2) + np.uint64(1),
        np.array([0, 2**64 - 1, 2**32, 2**32 - 1], dtype=np.uint64),
    ])
    steps = np.concatenate([
        rs.integers(0, 2**32, size=200, dtype=np.uint64).astype(np.uint32),
        np.array([0, 2**32 - 1, 5, 7], dtype=np.uint32),
    ])
    jd = jrng.Draw(jnp.asarray(seeds), jnp.asarray(steps))
    td = trng.Draw(
        torch.from_numpy(seeds.view(np.int64)), torch.from_numpy(steps.astype(np.int64))
    )

    def same(a, b):
        np.testing.assert_array_equal(
            np.asarray(a).astype(np.int64), b.numpy().astype(np.int64)
        )

    same(jd.k0, td.k0)
    same(jd.k1, td.k1)
    for purpose in (0, 1, 8, 14, 128, 128 + 7, 0x9E370000):
        same(jd.bits(purpose), td.bits(purpose))
        ja, jb = jd.bits2(purpose)
        ta, tb = td.bits2(purpose)
        same(ja, ta)
        same(jb, tb)
    purposes = [0, 8, 9, 10, 11, 12, 13, 14, 128]
    j0, j1 = jax.vmap(lambda d0, d1, s: jrng.Draw.from_parts(d0, d1, s).block2(
        jnp.asarray(purposes, jnp.uint32)))(jd.k0, jd.k1, jd.step)
    t0, t1 = td.block2(purposes)
    same(j0, t0)
    same(j1, t1)
    for lo, hi in ((50, 100), (150_000_000, 300_000_000), (0, 1000), (7, 7), (0, 2**32 - 1)):
        same(jd.uniform_int(lo, hi, 3), td.uniform_int(lo, hi, 3))
        same(jd.user_int(lo, hi, 0), td.user_int(lo, hi, 0))
    for thr in (0, 1, 2**31, 2**32 - 1, 2**32):
        same(jd.chance(thr, 9), td.chance(thr, 9))
    same(jd.user(4), td.user(4))
