"""Causal provenance: exact event lineage from a ``causal=True`` ring.

Port of ``madsim_tpu/obs/causal.py``; it reads the port's decoded rings
(``obs.decode_timeline``), whose causal columns the port's plain step
and run kernel fold exactly as the JAX engine does.

Reproducing a violation is not *explaining* it: the flight recorder
(obs/timeline.py) hands back the full dispatched-event stream, and a
human still has to guess which of those hundreds of rows actually led
to the bad state. Under the engine's ``causal=True`` build axis every
captured ring row carries exact lineage (engine/core.py make_step):

* ``seq``    — the dispatch's per-seed sequence number,
* ``parent`` — the seq of the dispatch that EMITTED this event (or a
  ``PARENT_*`` sentinel: init row, chaos/engine plan row, client-army
  row), folded on device the way ``ev_emit`` already was,
* ``lam``    — the destination node's Lamport clock after the
  happens-before fold ``lam[dst] = max(lam[dst], lam_at_emit) + 1``.

This module turns those columns into forensics. The happens-before
relation is the standard one — per-node program order (each node
dispatches serially) plus emit->deliver edges (the ``parent`` column)
— and :func:`causal_slice` computes the backward closure from a
violating record: the **cone** of events that can have influenced it.
Everything outside the cone is provably concurrent with the anchor and
can be ignored, which is the whole point — on real found violations
the cone is a small fraction of the captured ring (tools/causal_soak.py
banks the measured reduction).

``rederive`` recomputes seq/parent/lam host-side from nothing but the
event stream and checks them against the device fold — the refold
discipline (obs/timeline.py) applied to the causal columns, and the
test gate proving the device DAG and the replay derivation agree.
"""

from __future__ import annotations

import dataclasses

from ..engine.core import (
    PARENT_ARMY,
    PARENT_NONE,
    PARENT_PLAN,
    Workload,
)
from .timeline import decode_timeline

__all__ = [
    "CausalCone",
    "causal_slice",
    "derive_parents",
    "format_cone",
    "parent_class",
    "rederive",
]

# sentinel -> provenance class (engine/core.py PARENT_* numbering)
_PARENT_CLASS = {
    PARENT_NONE: "init",
    PARENT_PLAN: "plan",
    PARENT_ARMY: "army",
}


def parent_class(parent: int) -> str:
    """Provenance class of a ``ReplayEvent.parent`` value: ``"event"``
    for a real dispatch seq, else the sentinel's class (``"init"`` /
    ``"plan"`` / ``"army"``)."""
    if parent >= 0:
        return "event"
    return _PARENT_CLASS.get(parent, f"sentinel[{parent}]")


def _require_causal(events) -> None:
    if not events or events[0].seq < 0:
        raise ValueError(
            "timeline carries no causal columns — capture with causal=True "
            "(decoded rows have seq=-1, the pre-causal fallback)"
        )


def derive_parents(events) -> list:
    """Resolve each event's ``parent`` seq to a ring index (or None).

    None means either a sentinel class (init/plan/army — no emitting
    dispatch exists) or a parent dispatch the ring no longer holds
    (overflow dropped it, or capture started late): callers that need
    the distinction check ``parent_class(e.parent)``.
    """
    by_seq = {e.seq: i for i, e in enumerate(events)}
    return [
        by_seq.get(e.parent) if e.parent >= 0 else None for e in events
    ]


def rederive(events) -> list:
    """Host-side re-derivation of the Lamport column from the stream.

    Replays the device fold — per-node clock, ``max(clock, parent's
    post-fold clock) + 1`` — over the decoded events in ring order and
    returns the expected ``lam`` per row. Equality with the captured
    ``tl_lam`` is the DAG==derivation certificate (tests/test_causal.py
    pins it); a mismatch means the ring's edges don't describe the
    fold that actually ran. Only exact on un-truncated rings (a parent
    outside the ring re-derives from clock 0).
    """
    _require_causal(events)
    parents = derive_parents(events)
    clock: dict = {}
    lam = []
    for i, e in enumerate(events):
        p = parents[i]
        at_emit = lam[p] if p is not None else 0
        v = max(clock.get(e.node, 0), at_emit) + 1
        lam.append(v)
        clock[e.node] = v
    return lam


@dataclasses.dataclass(frozen=True)
class CausalCone:
    """The backward happens-before cone of one anchor event.

    ``indices`` are ring positions (sorted ascending — ring order is
    dispatch order, so iterating them narrates the cone in causal
    time); ``events`` is the full decoded ring the indices point into.
    ``missing_parents`` counts cone rows whose emitting dispatch the
    ring no longer holds — nonzero means the cone is a *prefix-sound*
    underapproximation (everything listed does precede the anchor, but
    dropped ancestors are absent), the tl_drop caveat in cone form.
    """

    seed: int
    events: list
    indices: tuple
    anchor: int
    missing_parents: int = 0

    @property
    def fraction(self) -> float:
        """Cone size over captured-ring size — the forensic reduction."""
        return len(self.indices) / max(len(self.events), 1)

    @property
    def chaos_indices(self) -> tuple:
        """Cone members that are injected chaos/plan dispatches — the
        fault windows that causally precede the anchor."""
        return tuple(
            i for i in self.indices
            if parent_class(self.events[i].parent) == "plan"
        )

    @property
    def depth(self) -> int:
        """Anchor's Lamport depth (longest causal chain ending there)."""
        return self.events[self.anchor].lam


def _resolve_anchor(events, anchor) -> int:
    if anchor is None:
        return len(events) - 1
    if isinstance(anchor, tuple):
        t_ns, node = anchor
        # a history record anchors at the dispatch that wrote it: the
        # last dispatch at its client node at-or-before the record time
        for i in range(len(events) - 1, -1, -1):
            if events[i].node == node and events[i].time_ns <= t_ns:
                return i
        raise ValueError(
            f"no dispatch at node {node} at-or-before t={t_ns} in the "
            f"captured ring — the anchor predates the capture"
        )
    i = int(anchor)
    if not 0 <= i < len(events):
        raise ValueError(
            f"anchor index {i} outside the captured ring "
            f"(0..{len(events) - 1})"
        )
    return i


def causal_slice(view, seed: int = 0, anchor=None, wl=None) -> CausalCone:
    """Backward happens-before cone from one event of a causal capture.

    ``view`` is anything :func:`~madsim_tpu_torch.obs.decode_timeline`
    accepts (a ``search_seeds`` view, ``SearchReport.timeline``, a raw
    batched ``SimState``) captured under ``causal=True``. ``anchor``
    selects the apex: ``None`` = the last captured event, an ``int`` =
    a ring index, or ``(time_ns, node)`` = the last dispatch at that
    node at-or-before the time — the form a violating history record's
    ``(hist_t, client)`` pair plugs into directly.

    The cone is the transitive closure over both happens-before edge
    classes: emit->deliver (the ``parent`` column) and per-node program
    order (the dispatch immediately before each cone member at the
    same node). By construction it is closed — every listed event's
    causes are listed too (modulo ``missing_parents``) — so replaying
    the cone alone re-derives the anchor's Lamport clock, and every
    event OUTSIDE it is concurrent with the anchor: no schedule
    reordering of those rows can change what the anchor saw.
    """
    events = (
        view if isinstance(view, list)
        else decode_timeline(view, wl, seed)
    )
    _require_causal(events)
    apex = _resolve_anchor(events, anchor)
    parents = derive_parents(events)
    # per-node program-order predecessor, one linear scan
    pred = [None] * len(events)
    last: dict = {}
    for i, e in enumerate(events):
        pred[i] = last.get(e.node)
        last[e.node] = i
    member = set()
    missing = 0
    work = [apex]
    while work:
        i = work.pop()
        if i in member:
            continue
        member.add(i)
        for j in (parents[i], pred[i]):
            if j is not None and j not in member:
                work.append(j)
        if events[i].parent >= 0 and parents[i] is None:
            missing += 1  # the emitting dispatch left the ring
    return CausalCone(
        seed=seed,
        events=events,
        indices=tuple(sorted(member)),
        anchor=apex,
        missing_parents=missing,
    )


def format_cone(
    cone: CausalCone, wl: Workload | None = None, max_events: int = 200
) -> str:
    """Narrate a cone: the lineage story ``obs.explain(causal=True)``
    prints instead of the whole stream."""
    from .telemetry import _fmt_event  # avoid a cycle at import time

    n, total = len(cone.indices), len(cone.events)
    lines = [
        f"--- causal cone: {n} of {total} captured events "
        f"({100.0 * cone.fraction:.0f}%) precede the anchor; "
        f"depth {cone.depth} (longest happens-before chain)"
    ]
    if cone.missing_parents:
        lines.append(
            f"    WARNING: {cone.missing_parents} cone row(s) cite an "
            f"emitting dispatch outside the ring — ancestry is "
            f"prefix-only (ring overflow or late capture)"
        )
    chaos = cone.chaos_indices
    if chaos:
        lines.append(
            f"    {len(chaos)} injected fault dispatch(es) inside the "
            f"cone — the chaos that causally precedes the violation:"
        )
        for i in chaos:
            lines.append(f"      {_fmt_event(cone.events[i], wl)}")
    shown = list(cone.indices)
    elided = 0
    if len(shown) > max_events:
        head = max_events // 3
        elided = len(shown) - max_events
        shown = shown[:head] + [None] + shown[-(max_events - head):]
    for i in shown:
        if i is None:
            lines.append(f"    ... {elided} cone rows elided ...")
            continue
        e = cone.events[i]
        cls = parent_class(e.parent)
        via = (f"<- seq {e.parent}" if cls == "event" else f"<- {cls}")
        mark = " ** ANCHOR" if i == cone.anchor else ""
        lines.append(
            f"  [seq {e.seq:>5} lam {e.lam:>5} {via:>11}] "
            f"{_fmt_event(e, wl)}{mark}"
        )
    return "\n".join(lines)
