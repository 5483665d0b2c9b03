"""Per-seed timeline decode: the captured event ring as readable events.

Port of ``madsim_tpu/obs/timeline.py``. The engine's timeline ring
(``make_init(timeline_cap=T)`` and a step built with the same ``T``)
records the dispatched-event stream, exactly the (time, kind, node,
src, args, payload) tuples the trace hash folds, as fixed-size per-seed
columns. This module decodes one seed's ring on the host into the same
:class:`~madsim_tpu_torch.engine.replay.ReplayEvent` rows the C++-oracle
replay produces, so ``engine.replay.format_timeline`` prints either.

:func:`refold_timeline` recomputes the trace hash from a decoded
timeline: when the ring did not overflow it equals the run's trace, which
proves that the captured story and the evidence are the same events.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.core import Workload
from ..engine.replay import ReplayEvent
from ..engine.replay import refold as _replay_refold

__all__ = ["decode_timeline", "refold_timeline", "timeline_counts"]


def _get(view, name: str) -> np.ndarray:
    """A column as numpy, from any shape a timeline travels in: a
    ``search_seeds`` view dict, a ``SearchReport.timeline`` namespace, a
    compacted result or a batched ``SimState`` (tensors on any device)."""
    x = view[name] if isinstance(view, dict) else getattr(view, name)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def timeline_counts(view) -> tuple:
    """(tl_count, tl_drop) numpy arrays over the seed axis."""
    return _get(view, "tl_count"), _get(view, "tl_drop")


def decode_timeline(view, wl: Workload | None = None, seed: int = 0) -> list:
    """Decode seed-row ``seed``'s captured ring into ReplayEvent rows.

    ``view`` is anything carrying the ``tl_*`` columns with a leading
    seed axis. ``wl`` is not needed (rows keep the captured arg width);
    it is accepted for the reference's signature."""
    del wl
    count = int(_get(view, "tl_count")[seed])
    t = _get(view, "tl_t")[seed]
    # a uint32 meta word (the port holds it in int64)
    meta = _get(view, "tl_meta")[seed].astype(np.int64) & 0xFFFFFFFF
    args = _get(view, "tl_args")[seed]
    pay = _get(view, "tl_pay")[seed]
    if t.shape[0] == 0:
        raise ValueError(
            "state carries no timeline columns — run with timeline_cap > 0"
        )
    # views that dropped the emit column decode with emit_ns = -1
    try:
        emit = _get(view, "tl_emit")[seed]
        if emit.shape[0] == 0:
            emit = None
    except (KeyError, AttributeError):
        emit = None
    # the causal columns (causal=True rings); a ring without them decodes
    # with the "not captured" defaults
    try:
        seq, parent, lam = (_get(view, f)[seed] for f in ("tl_seq", "tl_parent", "tl_lam"))
        if seq.shape[0] == 0:
            seq = parent = lam = None
    except (KeyError, AttributeError):
        seq = parent = lam = None
    events = []
    for i in range(count):
        m = int(meta[i])
        events.append(
            ReplayEvent(
                time_ns=int(t[i]),
                kind=m & 0xFF,
                node=((m >> 8) & 0xFF) - 1,
                src=((m >> 16) & 0xFF) - 1,
                args=tuple(int(x) for x in args[i]),
                pay=tuple(int(x) for x in pay[i]),
                emit_ns=int(emit[i]) if emit is not None else -1,
                seq=int(seq[i]) if seq is not None else -1,
                parent=int(parent[i]) if parent is not None else -1,
                lam=int(lam[i]) if lam is not None else 0,
            )
        )
    return events


def refold_timeline(events, wl: Workload) -> int:
    """Recompute the trace hash (a uint64) from a decoded timeline.

    Equals the run's ``SimState.trace`` for the same seed whenever the
    ring did not overflow (``tl_drop == 0``: a truncated stream refolds
    only a prefix). The ring captures payload words, so payload
    workloads refold too."""
    # the replay refold reads four arg words; the engine folds only
    # args_words, so the missing high words are zero
    padded = [
        ReplayEvent(
            time_ns=e.time_ns, kind=e.kind, node=e.node, src=e.src,
            args=tuple(e.args) + (0,) * (4 - len(e.args)), pay=e.pay,
        )
        for e in events
    ]
    return _replay_refold(padded, wl)
