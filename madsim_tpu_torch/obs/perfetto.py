"""Perfetto / Chrome trace-event export of a captured timeline.

Port of ``madsim_tpu/obs/perfetto.py``, a pure function of the decoded
events, so a port capture exports the same document as the JAX
package's capture of the same run.

Renders a decoded per-seed timeline (obs.decode_timeline — or any list
of ``engine.replay.ReplayEvent``) into the Trace Event JSON format that
``ui.perfetto.dev`` and ``chrome://tracing`` open directly:

* one **process track per node** — every dispatched event at that node
  is a slice, named by the workload's handler table;
* **message flow arrows** — each delivered message draws a flow from
  the sending node's track to the delivery slice. Causal captures
  (``ReplayEvent.parent``, engine ``ev_parent``/``tl_parent`` under
  ``causal=True``) attribute the arrow EXACTLY: it leaves the dispatch
  that emitted the message, by sequence number — no approximation at
  all. Rings captured with only the emit-time sidecar
  (``ReplayEvent.emit_ns``, engine ``ev_emit``/``tl_emit``) anchor the
  arrow at the true send time but attribute by node; older captures
  (``emit_ns < 0`` too) fall back to the historical approximation:
  the sender's last dispatch at-or-before the delivery — which two
  same-timestamp sends can mis-attribute (the tested reason the
  causal path exists). Client-army deliveries under a retry policy
  (``chaos.RetryPolicy``) name the arrow by **(op, attempt)** decoded
  from the packed op token, so a re-send of op 7 reads
  ``msg n1->n0 op7 try2`` — the same ambiguity class as the Duplicate
  mis-anchors banked in CAUSAL_r13.txt, disambiguated in the label
  whenever the send-time anchor (sidecar or causal) is present.
  Attempt-0 tokens are plain op ids, so off-policy traces are
  byte-identical to pre-retry exports;
* **chaos spans** — kill/restart, pause/resume, clog/unclog (node,
  link, and one-way forms), slow/unslow, dup on/off, and disk-fault
  (lying-fsync / torn-write) window pairs from the dispatched stream
  become duration slices on a dedicated "chaos" process, so a shrunk
  fault plan reads as shaded bands over the protocol's tracks.

The export is a pure function of the decoded events: the count of
``cat == "dispatch"`` slices always equals the timeline length (the
validity check the soak and tests pin).
"""

from __future__ import annotations

import json

from ..engine.core import (
    FIRST_EXT_KIND,
    FIRST_USER_KIND,
    KIND_CLOG,
    KIND_CLOG_1W,
    KIND_CLOG_NODE,
    KIND_DUP_OFF,
    KIND_DUP_ON,
    KIND_KILL,
    KIND_PAUSE,
    KIND_RESTART,
    KIND_RESUME,
    KIND_SKEW,
    KIND_SLOW_LINK,
    KIND_SYNC_LOSS,
    KIND_SYNC_OK,
    KIND_TORN_OFF,
    KIND_TORN_ON,
    KIND_UNCLOG,
    KIND_UNCLOG_1W,
    KIND_UNCLOG_NODE,
    KIND_UNSLOW,
    Workload,
    retry_token_attempt,
    retry_token_op,
    unpack_slow_arg,
)

__all__ = ["to_perfetto", "write_perfetto"]

# chaos spans ride one synthetic process so they band across the node
# tracks without colliding with node pids (nodes are 0..253)
_CHAOS_PID = 1000

# span-opening kind -> (closing kind, key function, label function).
# key identifies the pair (node id, link tuple, ...), so interleaved
# spans of different targets close independently.
_SPAN_PAIRS = {
    KIND_KILL: (KIND_RESTART, lambda a: ("node", a[0]),
                lambda a: f"killed n{a[0]}"),
    KIND_PAUSE: (KIND_RESUME, lambda a: ("node", a[0]),
                 lambda a: f"paused n{a[0]}"),
    KIND_CLOG: (KIND_UNCLOG, lambda a: ("link", *sorted(a[:2])),
                lambda a: f"partition n{a[0]}<->n{a[1]}"),
    KIND_CLOG_NODE: (KIND_UNCLOG_NODE, lambda a: ("nodeclog", a[0]),
                     lambda a: f"partition n{a[0]}"),
    KIND_CLOG_1W: (KIND_UNCLOG_1W, lambda a: ("link1w", a[0], a[1]),
                   lambda a: f"partition n{a[0]}->n{a[1]}"),
    KIND_SLOW_LINK: (
        KIND_UNSLOW,
        lambda a: ("slow", a[0], unpack_slow_arg(a[1])[0]),
        lambda a: (
            f"slow n{a[0]}<->"
            f"{'*' if unpack_slow_arg(a[1])[0] < 0 else 'n%d' % unpack_slow_arg(a[1])[0]}"
            f" x{unpack_slow_arg(a[1])[1]}"
        ),
    ),
    KIND_DUP_ON: (KIND_DUP_OFF, lambda a: ("dup",), lambda a: "duplication"),
    # disk-fault windows (chaos.DiskFault): a0 = node, -1 = every node
    KIND_SYNC_LOSS: (
        KIND_SYNC_OK, lambda a: ("syncloss", a[0]),
        lambda a: f"lying fsync {'n%d' % a[0] if a[0] >= 0 else '*'}",
    ),
    KIND_TORN_ON: (
        KIND_TORN_OFF, lambda a: ("torn", a[0]),
        lambda a: f"torn writes {'n%d' % a[0] if a[0] >= 0 else '*'}",
    ),
}
_SPAN_CLOSERS = {v[0]: k for k, v in _SPAN_PAIRS.items()}


def _us(t_ns: int) -> float:
    """Trace-event timestamps are microseconds (fractions allowed)."""
    return t_ns / 1e3


def _flow_name(e) -> str:
    """Arrow label for a delivery — attempt-aware for retried ops.

    User-kind deliveries carry a packed op token in ``args[0]``
    (engine.retry_token); a nonzero attempt id marks a RetryPolicy
    re-send, which is the same arrow-anchoring ambiguity as a
    Duplicate re-delivery (CAUSAL_r13.txt) — so the label names the
    (op, attempt) pair and the anchor (sidecar emit time or causal
    parent) disambiguates which send the arrow leaves. Attempt-0
    tokens are plain op ids: off-policy labels are unchanged.
    """
    base = f"msg n{e.src}->n{e.node}"
    if FIRST_USER_KIND <= e.kind < FIRST_EXT_KIND and len(e.args) > 0:
        att = retry_token_attempt(int(e.args[0]))
        if att > 0:
            return f"{base} op{retry_token_op(int(e.args[0]))} try{att}"
    return base


def to_perfetto(
    events,
    wl: Workload | None = None,
    name: str = "madsim",
    seed: int | None = None,
) -> dict:
    """Render decoded timeline events as a trace-event JSON dict.

    ``events`` is the ``obs.decode_timeline`` output (ReplayEvent rows,
    dispatch order). Serialize with ``json.dump`` or
    :func:`write_perfetto`; the result opens in ui.perfetto.dev as-is.
    """
    events = list(events)
    out = []
    is_engine = lambda k: k < FIRST_USER_KIND or k >= FIRST_EXT_KIND  # noqa: E731
    # engine/chaos events ride the chaos process: their pool rows target
    # node 0 by convention (chaos plan layout), which is not where the
    # fault acts — the span pairing below shows the real targets
    nodes = sorted({
        e.node for e in events if e.node >= 0 and not is_engine(e.kind)
    })
    wl_name = getattr(wl, "name", None) or name

    for n in nodes:
        out.append({
            "ph": "M", "name": "process_name", "pid": n, "tid": 0,
            "args": {"name": f"node {n} ({wl_name})"},
        })
        out.append({
            "ph": "M", "name": "process_sort_index", "pid": n, "tid": 0,
            "args": {"sort_index": n},
        })
    out.append({
        "ph": "M", "name": "process_name", "pid": _CHAOS_PID, "tid": 0,
        "args": {"name": "chaos"},
    })
    out.append({
        "ph": "M", "name": "process_sort_index", "pid": _CHAOS_PID,
        "tid": 0, "args": {"sort_index": -1},
    })

    # per-node next-event gap bounds each slice's duration so adjacent
    # dispatches never overlap; 200 us default keeps slices visible at
    # the 1-10 ms latency scale
    next_at: dict = {}
    by_node_rev: dict = {}
    for i in reversed(range(len(events))):
        e = events[i]
        next_at[i] = by_node_rev.get(e.node)
        by_node_rev[e.node] = e.time_ns
    end_ns = events[-1].time_ns if events else 0

    # dispatch slices: one per timeline event — the count invariant
    # seq -> ring index for exact parent attribution (causal captures)
    by_seq = {
        e.seq: i for i, e in enumerate(events) if getattr(e, "seq", -1) >= 0
    }
    last_idx_at_node: dict = {}
    flow_id = 0
    for i, e in enumerate(events):
        eng = is_engine(e.kind)
        pid = e.node if (e.node >= 0 and not eng) else _CHAOS_PID
        dur_ns = 200_000
        nxt = next_at.get(i)
        if nxt is not None and nxt > e.time_ns:
            dur_ns = min(dur_ns, nxt - e.time_ns)
        dur_ns = max(dur_ns, 1_000)
        row = {
            "ph": "X", "cat": "dispatch",
            "name": e.kind_name(wl),
            "pid": pid, "tid": 0,
            "ts": _us(e.time_ns), "dur": _us(dur_ns),
            "args": {
                "t_ms": e.time_ns / 1e6,
                "kind": e.kind,
                "src": e.src,
                "ev_args": list(e.args),
            },
        }
        if getattr(e, "seq", -1) >= 0:
            row["args"].update(seq=e.seq, parent=e.parent, lam=e.lam)
        out.append(row)
        # message flow arrow, best provenance first: exact emitting
        # dispatch (causal parent seq) > true send time (emit sidecar)
        # > the sender's last dispatch at-or-before this delivery (see
        # the module docstring)
        emit_ns = getattr(e, "emit_ns", -1)
        parent_i = (
            by_seq.get(e.parent)
            if getattr(e, "parent", -1) >= 0 else None
        )
        if e.src >= 0 and parent_i is not None:
            p = events[parent_i]
            out.append({
                "ph": "s", "cat": "flow", "id": flow_id,
                "name": _flow_name(e),
                "pid": p.node, "tid": 0,
                # the emitting dispatch's own timestamp IS the send
                # time (emission happens during its handler), so the
                # exact arrow needs no sidecar — but keep the finer
                # emit_ns anchor when both were captured
                "ts": _us(emit_ns if emit_ns >= 0 else p.time_ns),
            })
            out.append({
                "ph": "f", "cat": "flow", "id": flow_id, "bp": "e",
                "name": _flow_name(e),
                "pid": pid, "tid": 0, "ts": _us(e.time_ns),
            })
            flow_id += 1
        elif e.src >= 0 and emit_ns >= 0:
            out.append({
                "ph": "s", "cat": "flow", "id": flow_id,
                "name": _flow_name(e),
                "pid": e.src, "tid": 0, "ts": _us(emit_ns),
            })
            out.append({
                "ph": "f", "cat": "flow", "id": flow_id, "bp": "e",
                "name": _flow_name(e),
                "pid": pid, "tid": 0, "ts": _us(e.time_ns),
            })
            flow_id += 1
        elif e.src >= 0 and e.src in last_idx_at_node:
            s = events[last_idx_at_node[e.src]]
            out.append({
                "ph": "s", "cat": "flow", "id": flow_id,
                "name": _flow_name(e),
                "pid": s.node, "tid": 0, "ts": _us(s.time_ns),
            })
            out.append({
                "ph": "f", "cat": "flow", "id": flow_id, "bp": "e",
                "name": _flow_name(e),
                "pid": pid, "tid": 0, "ts": _us(e.time_ns),
            })
            flow_id += 1
        if e.node >= 0 and not eng:
            last_idx_at_node[e.node] = i

    # chaos spans: pair engine fault kinds from the same stream
    open_spans: dict = {}
    chaos_tids: dict = {}

    def _tid(key) -> int:
        if key not in chaos_tids:
            chaos_tids[key] = len(chaos_tids) + 1
        return chaos_tids[key]

    for e in events:
        if not is_engine(e.kind):
            continue
        if e.kind in _SPAN_PAIRS:
            _closer, keyf, labelf = _SPAN_PAIRS[e.kind]
            open_spans[keyf(e.args)] = (e.time_ns, labelf(e.args))
        elif e.kind in _SPAN_CLOSERS:
            opener = _SPAN_CLOSERS[e.kind]
            key = _SPAN_PAIRS[opener][1](e.args)
            started = open_spans.pop(key, None)
            if started is not None:
                t0, label = started
                out.append({
                    "ph": "X", "cat": "chaos", "name": label,
                    "pid": _CHAOS_PID, "tid": _tid(key),
                    "ts": _us(t0), "dur": _us(max(e.time_ns - t0, 1_000)),
                })
        elif e.kind == KIND_SKEW:
            out.append({
                "ph": "i", "cat": "chaos", "s": "g",
                "name": f"skew n{e.args[0]} {e.args[1]}ns",
                "pid": _CHAOS_PID, "tid": _tid(("skew",)),
                "ts": _us(e.time_ns),
            })
    # unclosed spans run to the end of the capture
    for key, (t0, label) in open_spans.items():
        out.append({
            "ph": "X", "cat": "chaos", "name": label,
            "pid": _CHAOS_PID, "tid": _tid(key),
            "ts": _us(t0), "dur": _us(max(end_ns - t0, 1_000)),
        })
    for key, tid in chaos_tids.items():
        out.append({
            "ph": "M", "name": "thread_name", "pid": _CHAOS_PID,
            "tid": tid, "args": {"name": "/".join(str(k) for k in key)},
        })

    meta = {"workload": wl_name, "events": len(events)}
    if seed is not None:
        meta["seed"] = int(seed)
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": meta,
    }


def write_perfetto(path: str, events, wl: Workload | None = None, **kw) -> dict:
    """``to_perfetto`` + serialize to ``path``; returns the dict."""
    doc = to_perfetto(events, wl, **kw)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc
