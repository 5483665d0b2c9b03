"""The port's history screens (``madsim_tpu_torch/check/device.py``)
against the JAX package's ``madsim_tpu.check.device`` and the port's
numpy checkers, in one process, exact.

* the oracle table of ``tests/test_check_device.py`` (copied): every
  fixture judged by the port's screens, the JAX package's and the port's
  numpy detector, all equal to the expected verdict;
* a fuzz over all nine screen kinds on random histories (64 seeds, 24
  rows, some seeds dropped records), at the default chunk and at a
  chunk of 5 seeds, whose last chunk is shorter;
* ``collapse_retries_cols``, the verdict words and ``fold_verified``
  against the JAX package's on fuzzed histories, and the two fold
  fixtures of ``TestPrefixCompaction``.

Inputs are made with numpy from fixed seeds; torch runs on the CPU with
``torch.use_deterministic_algorithms(True)``.
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

from madsim_tpu.check import device as jdc
from madsim_tpu_torch.check import BatchHistory
from madsim_tpu_torch.check import device as tdc
from madsim_tpu_torch.check import vectorized as tv
from madsim_tpu_torch.check.history import (
    OK_FAIL, OK_OK, OK_PENDING, OP_READ, OP_USER, OP_WRITE, pack_shard_own,
)

S, H = 64, 24


@pytest.fixture(autouse=True)
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def _hist(*seeds):
    """Synthetic BatchHistory: each seed a list of (op, key, arg, client,
    ok) records in buffer order (t = index)."""
    h = max((len(rows) for rows in seeds), default=0)
    word = np.zeros((len(seeds), h, 5), np.int32)
    t = np.zeros((len(seeds), h), np.int64)
    count = np.zeros((len(seeds),), np.int32)
    for i, rows in enumerate(seeds):
        count[i] = len(rows)
        for j, rec in enumerate(rows):
            word[i, j] = rec
            t[i, j] = j
    return BatchHistory(word=word, t=t, count=count, drop=np.zeros((len(seeds),), np.int32))


def _cols(h):
    return (torch.from_numpy(h.word), torch.from_numpy(h.t), torch.from_numpy(h.count),
            torch.from_numpy(h.drop))


def _jax_screen(screen):
    """The JAX package's screen of the same kind and ops."""
    return jdc.HistoryScreen(screen.kind, screen.op_a, screen.op_b)


def _port(screens, h):
    return tdc.screen_ok(screens, *_cols(h)).numpy()


def _jax(screens, h):
    return np.asarray(jdc.screen_ok(tuple(_jax_screen(s) for s in screens),
                                    h.word, h.t, h.count, h.drop))


def _quarantined(h):
    """The history the host path judges: dropped seeds as empty."""
    return BatchHistory(word=h.word, t=h.t, count=np.where(h.drop > 0, 0, h.count).astype(np.int32),
                        drop=np.zeros_like(h.drop))


W, R = OP_WRITE, OP_READ
# tests/test_check_device.py's oracle table: (name, screen, rows, verdict)
ORACLE = [
    ("stale/paired-invoke-in-flight-write", tdc.stale_reads(),
     [(W, 0, 1, 0, OK_OK), (R, 0, 0, 1, OK_PENDING), (W, 0, 2, 0, OK_OK), (R, 0, 1, 1, OK_OK)],
     True),
    ("stale/paired-invoke-lost-write", tdc.stale_reads(),
     [(W, 0, 1, 0, OK_OK), (W, 0, 2, 0, OK_OK), (R, 0, 0, 1, OK_PENDING), (R, 0, 1, 1, OK_OK)],
     False),
    ("stale/bare-response-floor-at-own-slot", tdc.stale_reads(),
     [(W, 0, 2, 0, OK_OK), (R, 0, 1, 1, OK_OK)], False),
    ("stale/bare-response-clean", tdc.stale_reads(),
     [(W, 0, 2, 0, OK_OK), (R, 0, 2, 1, OK_OK)], True),
    ("stale/invoke-after-response-unconstrained", tdc.stale_reads(),
     [(W, 0, 2, 0, OK_OK), (R, 0, 0, 1, OK_OK), (R, 0, 9, 1, OK_PENDING)], True),
    ("stale/failed-read-unconstrained", tdc.stale_reads(),
     [(W, 0, 2, 0, OK_OK), (R, 0, 0, 1, OK_PENDING), (R, 0, 0, 1, OK_FAIL)], True),
    ("ryw/other-clients-write-ignored", tdc.read_your_writes(),
     [(W, 0, 5, 0, OK_OK), (R, 0, 0, 1, OK_PENDING), (R, 0, 0, 1, OK_OK)], True),
    ("ryw/own-write-enforced", tdc.read_your_writes(),
     [(W, 0, 5, 1, OK_OK), (R, 0, 0, 1, OK_PENDING), (R, 0, 0, 1, OK_OK)], False),
    ("monotonic/pipelined-out-of-order-ok", tdc.monotonic_reads(),
     [(R, 0, 0, 0, OK_PENDING), (R, 0, 0, 0, OK_PENDING), (R, 0, 2, 0, OK_OK),
      (R, 0, 1, 0, OK_OK)], True),
    ("monotonic-strict/flags-pipelined", tdc.monotonic_reads_strict(),
     [(R, 0, 0, 0, OK_PENDING), (R, 0, 0, 0, OK_PENDING), (R, 0, 2, 0, OK_OK),
      (R, 0, 1, 0, OK_OK)], False),
    ("monotonic/sequential-regression", tdc.monotonic_reads(),
     [(R, 0, 0, 0, OK_PENDING), (R, 0, 2, 0, OK_OK), (R, 0, 0, 0, OK_PENDING),
      (R, 0, 1, 0, OK_OK)], False),
    ("election/two-winners", tdc.election_safety(OP_USER),
     [(OP_USER, 3, 1, 1, OK_OK), (OP_USER, 3, 2, 2, OK_OK)], False),
    ("election/re-record-same-winner", tdc.election_safety(OP_USER),
     [(OP_USER, 3, 1, 1, OK_OK), (OP_USER, 3, 1, 1, OK_OK), (OP_USER, 4, 2, 2, OK_OK)], True),
    ("recovery/truncation-resync-ok", tdc.recovery_safety(OP_USER + 2, OP_USER + 3),
     [(OP_USER + 2, 0, 5, 1, OK_OK), (OP_USER + 2, 0, 3, 1, OK_OK),
      (OP_USER + 3, 0, 3, 1, OK_OK)], True),
    ("recovery/regression-flagged", tdc.recovery_safety(OP_USER + 2, OP_USER + 3),
     [(OP_USER + 2, 0, 5, 1, OK_OK), (OP_USER + 3, 0, 2, 1, OK_OK)], False),
    ("recovery/other-node-sync-ignored", tdc.recovery_safety(OP_USER + 2, OP_USER + 3),
     [(OP_USER + 2, 0, 5, 2, OK_OK), (OP_USER + 3, 0, 0, 1, OK_OK)], True),
]


@pytest.mark.parametrize("name,screen,rows,expect", ORACLE, ids=[o[0] for o in ORACLE])
def test_oracle_fixture(name, screen, rows, expect):
    h = _hist(rows)
    host = np.asarray(screen.host(h), bool)
    assert host[0] == expect, f"numpy oracle drifted on {name}"
    assert _port((screen,), h)[0] == expect
    assert _jax((screen,), h)[0] == expect


# every kind, at ops that the fuzz's op codes 1..3 exercise
FUZZ_SCREENS = (
    tdc.stale_reads(), tdc.read_your_writes(), tdc.monotonic_reads(),
    tdc.monotonic_reads_strict(), tdc.election_safety(3), tdc.recovery_safety(3, 1),
    tdc.lease_safety(2, 3), tdc.shard_coverage(3, 1), tdc.exactly_once(3),
)


def _fuzz(seed: int, ops=3, keys=2, clients=2, s=S, h=H):
    """Random histories: ``count`` 0..h, every seventh seed dropped
    records; in half the seeds the arg packs a shard install (epoch,
    group, version)."""
    rng = np.random.default_rng(seed)
    word = np.zeros((s, h, 5), np.int32)
    word[:, :, 0] = rng.integers(1, ops + 1, (s, h))
    word[:, :, 1] = rng.integers(0, keys, (s, h))
    word[:, :, 2] = rng.integers(0, 6, (s, h))
    packed = pack_shard_own(rng.integers(0, 2, (s, h)), rng.integers(0, 2, (s, h)),
                            rng.integers(0, 6, (s, h)))
    word[s // 2:, :, 2] = packed[s // 2:]
    word[:, :, 3] = rng.integers(0, clients, (s, h))
    word[:, :, 4] = rng.integers(-1, 2, (s, h))
    drop = np.where(np.arange(s) % 7 == 3, 2, 0).astype(np.int32)
    return BatchHistory(word=word, t=rng.integers(0, 10**12, (s, h)).astype(np.int64),
                        count=rng.integers(0, h + 1, (s,)).astype(np.int32), drop=drop)


@pytest.fixture(params=[None, 5], ids=["chunk-default", "chunk-5"])
def chunk(request, monkeypatch):
    if request.param is not None:
        monkeypatch.setattr(tdc, "_CHUNK", request.param)
    return request.param


@pytest.mark.parametrize("screen", FUZZ_SCREENS, ids=[s.kind for s in FUZZ_SCREENS])
def test_fuzz_every_kind_equals_jax_and_numpy(screen, chunk):
    h = _fuzz(2)
    got = _port((screen,), h)
    np.testing.assert_array_equal(got, _jax((screen,), h))
    np.testing.assert_array_equal(got, np.asarray(screen.host(_quarantined(h)), bool))
    assert got[h.drop > 0].all()
    assert not got.all() and got.any(), f"degenerate fuzz for {screen.kind}"


def test_fuzz_all_screens_together(chunk):
    h = _fuzz(7)
    got = _port(FUZZ_SCREENS, h)
    np.testing.assert_array_equal(got, _jax(FUZZ_SCREENS, h))
    np.testing.assert_array_equal(got, tdc.screens_invariant(FUZZ_SCREENS)(_quarantined(h)))


def test_collapse_retries_cols_equals_jax_and_numpy(chunk):
    h = _fuzz(3, ops=2, keys=2, clients=2)
    got = tdc.collapse_retries_cols(torch.from_numpy(h.word), torch.from_numpy(h.count)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdc.collapse_retries_cols(h.word, h.count)))
    np.testing.assert_array_equal(got, tv.collapse_retries(h).word)
    cleared = (got[..., 0] == 0) & (h.word[..., 0] != 0)
    assert cleared.any() and (got[..., 1:] == h.word[..., 1:]).all()


@pytest.mark.parametrize("n", [1, 31, 32, 33])
def test_verdict_words_equal_jax(n):
    ok = (np.arange(n) % 3) != 0
    words = tdc.pack_verdicts(torch.from_numpy(ok))
    assert words.dtype == torch.int64 and words.shape == ((n + 31) // 32,)
    host = tdc.verdict_words_to_numpy(words)
    np.testing.assert_array_equal(host, np.asarray(jdc.pack_verdicts(ok)))
    np.testing.assert_array_equal(tdc.pack_verdicts_host(ok), host)
    np.testing.assert_array_equal(tdc.unpack_verdicts(words, n), ok)
    np.testing.assert_array_equal(tdc.unpack_verdicts(host, n), ok)


def test_fold_verified_equals_jax(chunk):
    h = _fuzz(11, ops=2, keys=2, clients=2)
    ok = np.random.default_rng(5).random(S) < 0.7
    got = tdc.fold_verified(*_cols(h), torch.from_numpy(ok))
    want = jdc.fold_verified(h.word, h.t, h.count, h.drop, ok)
    for name, g, w in zip(("word", "t", "count", "fold"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    count, fold = got[2].numpy(), got[3].numpy()
    np.testing.assert_array_equal(count + fold, h.count)
    kept = ~ok | (h.drop > 0)
    assert (fold[kept] == 0).all() and (fold[~kept] > 0).any()
    # flagged and overflowed seeds verbatim; every seed's rows past its
    # kept count zero
    valid = np.arange(H)[None, :] < h.count[:, None]
    np.testing.assert_array_equal(got[0].numpy()[kept], np.where(valid[..., None], h.word, 0)[kept])


def test_fold_keeps_fifo_pending_invokes_only():
    # I1 R1 R2 I2: R1 closes I1, R2 is instantaneous, I2 stays pending
    h = _hist([(W, 0, 1, 0, OK_PENDING), (W, 0, 1, 0, OK_OK), (W, 0, 9, 0, OK_OK),
               (W, 0, 2, 0, OK_PENDING)])
    w2, t2, c2, fold = tdc.fold_verified(*_cols(h), torch.tensor([True]))
    assert int(c2[0]) == 1 and int(fold[0]) == 3
    assert tuple(w2[0, 0].tolist()) == (W, 0, 2, 0, OK_PENDING)
    assert int(t2[0, 0]) == 3  # the original clock rides along
    assert not w2[0, 1:].any() and not t2[0, 1:].any()


def test_flagged_and_overflowed_seeds_keep_everything():
    rows = [(W, 0, 1, 0, OK_PENDING), (W, 0, 1, 0, OK_OK)]
    h = _hist(rows, rows)
    h.drop[1] = 2
    w2, t2, c2, fold = tdc.fold_verified(*_cols(h), torch.tensor([False, True]))
    np.testing.assert_array_equal(c2.numpy(), h.count)
    np.testing.assert_array_equal(fold.numpy(), [0, 0])
    np.testing.assert_array_equal(w2.numpy(), h.word)
    np.testing.assert_array_equal(t2.numpy(), h.t)


def test_screen_spec_validation():
    with pytest.raises(ValueError, match="unknown screen kind"):
        tdc.HistoryScreen("linearizable_wing_gong")
    with pytest.raises(ValueError, match="non-empty"):
        tdc.as_screens(())
    assert tdc.as_screens(tdc.stale_reads()) == (tdc.stale_reads(),)
    assert hash(tdc.stale_reads()) == hash(tdc.stale_reads())
    assert [s.kind for s in tdc.default_screens()] == [s.kind for s in jdc.default_screens()]
    assert [(s.op_a, s.op_b) for s in tdc.default_screens()] == \
        [(s.op_a, s.op_b) for s in jdc.default_screens()]
    assert tdc.screens_invariant(FUZZ_SCREENS[:2]).__name__ == "stale_reads+read_your_writes"
