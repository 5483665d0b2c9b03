"""The port's determinism checks.

``check_determinism`` passes on a deterministic workload and names the
first diverging seed of one that is not; the field comparison that
``check_layouts`` runs names a corrupted field and its seed, with the
reference's wording; ``check_layouts`` needs a card, where the port has
two lowerings (the fused kernel and the plain step).
"""

import _torch_threads  # noqa: F401
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from madsim_tpu.engine.verify import compare_traces as j_compare_traces
from madsim_tpu.runtime.rand import DeterminismError as JDeterminismError
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.engine.verify import (
    HISTORY_FIELDS,
    LAYOUT_FIELDS,
    DeterminismError,
    check_determinism,
    check_layouts,
    compare_fields,
    compare_traces,
)
from madsim_tpu_torch.models import BENCH_SPECS, make_kvchaos, make_raft

RAFT_KW = BENCH_SPECS["raft"][1]
SEEDS = np.arange(32, dtype=np.uint64) * np.uint64(101)


def _raft_run(n_steps=60, record=False):
    wl, cfg = make_raft(record=record), tcore.EngineConfig(**RAFT_KW)
    return tcore.make_run(wl, cfg, n_steps)(tcore.make_init(wl, cfg, device="cpu")(SEEDS))


@pytest.mark.parametrize(
    "factory,kw,n_steps",
    [(make_raft, RAFT_KW, 60), (make_kvchaos, BENCH_SPECS["kvchaos"][1], 200)],
    ids=["raft", "kvchaos"],
)
def test_check_determinism_passes_on_the_models(factory, kw, n_steps):
    check_determinism(factory(), tcore.EngineConfig(**kw), SEEDS, n_steps, device="cpu")


def test_check_determinism_catches_a_handler_with_hidden_state():
    calls = [0]

    def on_init(ctx):
        # a handler that reads state outside the simulation
        calls[0] += 1
        em = ctx.emits()
        em.after(1000 * calls[0], tcore.user_kind(1), ctx.node)
        return ctx.state, em.build()

    def tick(ctx):
        em = ctx.emits()
        em.halt()
        return ctx.state, em.build()

    wl = tcore.Workload(name="flaky", n_nodes=2, state_width=1,
                        handlers=(on_init, tick), max_emits=2, args_words=2)
    with pytest.raises(DeterminismError, match="flaky x2: seed index 0"):
        check_determinism(wl, tcore.EngineConfig(pool_size=8), SEEDS[:4], 6, device="cpu")


@pytest.mark.parametrize("field", LAYOUT_FIELDS)
def test_compare_fields_names_a_corrupted_field(field):
    # the history columns are corrupted in a run that records
    history = field in HISTORY_FIELDS
    a = _raft_run(record=history)
    b = tcore.SimState(**{f: getattr(a, f).clone() for f in tcore.STATE_FIELDS})
    col = getattr(b, field)
    col[5] = ~col[5] if col.dtype == torch.bool else col[5] + 1
    compare_fields(a, a, what="same")
    with pytest.raises(DeterminismError, match=rf"x: field '{field}' diverged at seed index 5 "
                                               rf"\(seed {int(SEEDS[5])}\)"):
        compare_fields(a, b, what="x")
    compare_traces(a, b, what="x", history=False)  # the trace does not see it
    if history:
        with pytest.raises(DeterminismError, match=rf"history field '{field}' diverged"):
            compare_traces(a, b, what="x")


def test_compare_traces_words_as_the_reference():
    a = _raft_run()
    b = tcore.SimState(**{f: getattr(a, f).clone() for f in tcore.STATE_FIELDS})
    b.trace[7] ^= 1 << 63
    with pytest.raises(DeterminismError) as got:
        compare_traces(a, b, what="raft x2")
    na, nb = state_to_numpy(a), state_to_numpy(b)
    with pytest.raises(JDeterminismError) as want:
        j_compare_traces(SimpleNamespace(**na), SimpleNamespace(**nb), what="raft x2")
    assert str(got.value) == str(want.value)


def test_check_layouts_needs_a_card():
    with pytest.raises(ValueError, match="one lowering"):
        check_layouts(make_raft(), tcore.EngineConfig(**RAFT_KW), SEEDS, 10, device="cpu")
