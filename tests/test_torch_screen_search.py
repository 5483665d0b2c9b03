"""The device screens in the port's runners, against the JAX package's.

``make_run_compacted(hist_screen=...)`` and
``search_seeds(device_check=...)`` (lockstep and compact) on the
kvchaos lost-write mutant (``writes=5, record=True, bug=True``) at the
configuration of the JAX package's ``tests/test_check_device.py`` (pool
40, loss 0.02, 600 steps), the plain step on the CPU. Seeds 0..57: seed
57 is the first seed that the JAX package's screens flag there, so 58
is the smallest batch with a violation. Exact equality of verdicts,
verdict words, flagged seeds and folded columns; every flagged history
fails the exact checker.
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest
import torch

import madsim_tpu.engine as je
from madsim_tpu.check import device as jdc
from madsim_tpu.models import make_kvchaos as j_kv
from madsim_tpu_torch.check import BatchHistory, check_kv
from madsim_tpu_torch.check import device as tdc
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import search_seeds
from madsim_tpu_torch.engine.compact import RESULT_FIELDS, SCREEN_FIELDS, make_run_compacted
from madsim_tpu_torch.models import make_kvchaos as t_kv

KW = dict(pool_size=40, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
CAP, N = 600, 58
SEEDS = np.arange(N, dtype=np.uint64)
SCREENS = (tdc.stale_reads(), tdc.read_your_writes(), tdc.monotonic_reads())
J_SCREENS = (jdc.stale_reads(), jdc.read_your_writes(), jdc.monotonic_reads())
# several banks: 58 rows, then 29, then 14
PHASES = dict(shrink=2, min_size=8)


@pytest.fixture(autouse=True)
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's lockstep screened search and screened
    compacted run."""
    wl, cfg = j_kv(writes=5, record=True, bug=True), je.EngineConfig(**KW)
    rep = je.search_seeds(wl, cfg, None, n_seeds=N, max_steps=CAP, require_halt=False,
                          device_check=J_SCREENS)
    out = je.make_run_compacted(wl, cfg, CAP, time32=False, hist_screen=J_SCREENS, **PHASES)(
        je.make_init(wl, cfg, time32=False)(SEEDS))
    return rep, out


@pytest.fixture(scope="module")
def port_runs():
    """The port's compacted run without and with the screens."""
    wl, cfg = t_kv(writes=5, record=True, bug=True), tcore.EngineConfig(**KW)
    st = tcore.make_init(wl, cfg, device="cpu")(SEEDS)
    plain = make_run_compacted(wl, cfg, CAP, **PHASES)(st)
    folded = make_run_compacted(wl, cfg, CAP, hist_screen=SCREENS, **PHASES)(st)
    return plain, folded


def test_compacted_screen_folds_losslessly_and_equals_reference(reference, port_runs):
    _rep, jout = reference
    plain, folded = port_runs
    for f in RESULT_FIELDS + SCREEN_FIELDS:
        want, got = np.asarray(getattr(jout, f)), getattr(folded, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    # nothing vanishes: the fold is counted
    np.testing.assert_array_equal(folded.hist_count + folded.hist_fold, plain.hist_count)
    np.testing.assert_array_equal(folded.hist_drop, plain.hist_drop)
    flag = ~folded.hist_ok
    assert flag.any() and not flag.all()
    np.testing.assert_array_equal(folded.hist_word[flag], plain.hist_word[flag])
    np.testing.assert_array_equal(folded.hist_t[flag], plain.hist_t[flag])
    assert (folded.hist_fold[~flag] > 0).all()
    # the verdicts are the numpy detectors' on the unfolded columns
    np.testing.assert_array_equal(folded.hist_ok,
                                  tdc.screens_invariant(SCREENS)(BatchHistory.from_view(vars(plain))))
    for f in set(RESULT_FIELDS) - {"hist_word", "hist_t", "hist_count"}:
        np.testing.assert_array_equal(getattr(folded, f), getattr(plain, f), err_msg=f)


@pytest.mark.parametrize("compact", [False, True], ids=["lockstep", "compact"])
def test_device_check_search_equals_reference(reference, port_runs, compact):
    jrep, jout = reference
    plain, _folded = port_runs
    rep = search_seeds(t_kv(writes=5, record=True, bug=True), tcore.EngineConfig(**KW), None,
                       n_seeds=N, max_steps=CAP, require_halt=False, device="cpu",
                       device_check=SCREENS, compact=compact)
    for attr in ("ok", "screen_ok", "flagged_idx", "verdict_words", "failing_seeds", "traces",
                 "overflowed"):
        got, want = getattr(rep, attr), np.asarray(getattr(jrep, attr))
        assert got.dtype == want.dtype, attr
        np.testing.assert_array_equal(got, want, err_msg=attr)
    assert rep.flagged_idx.tolist() == [57]
    if compact:
        np.testing.assert_array_equal(rep.hist_fold, jout.hist_fold)
        assert "records prefix-compacted" in rep.banner()
    else:
        assert rep.hist_fold is None
        assert rep.banner() == jrep.banner()
    # the escalation input: the flagged seeds' full histories, each of
    # which fails the exact checker
    fh = rep.flagged_history
    np.testing.assert_array_equal(fh.word, plain.hist_word[rep.flagged_idx])
    np.testing.assert_array_equal(fh.t, plain.hist_t[rep.flagged_idx])
    np.testing.assert_array_equal(fh.count, plain.hist_count[rep.flagged_idx])
    for i in range(len(fh)):
        assert not check_kv(fh.ops(i)).ok


def test_device_check_arguments_are_validated():
    cfg = tcore.EngineConfig(**KW)
    with pytest.raises(ValueError, match="device_check judges operation histories"):
        search_seeds(t_kv(writes=5), cfg, None, n_seeds=4, max_steps=10, device="cpu",
                     device_check=SCREENS)
    wl = t_kv(writes=5, record=True)
    with pytest.raises(ValueError, match="not both"):
        search_seeds(wl, cfg, None, n_seeds=4, max_steps=10, device="cpu", device_check=SCREENS,
                     history_invariant=tdc.screens_invariant(SCREENS))
    with pytest.raises(ValueError, match="non-empty"):
        search_seeds(wl, cfg, None, n_seeds=4, max_steps=10, device="cpu", device_check=())
    with pytest.raises(ValueError, match="need an invariant, a history_invariant or a device_check"):
        search_seeds(wl, cfg, None, n_seeds=4, max_steps=10, device="cpu")
