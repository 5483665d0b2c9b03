"""Campaign telemetry and the per-violation ``explain`` narrative.

Port of ``madsim_tpu/obs/telemetry.py``. Two consumers of the
observability columns live here:

* :class:`JsonlSink` — the structured-progress writer the exploration
  drivers (``explore.run(telemetry=...)``, ``run_device``) and the farm
  emit through: one JSON object per line (coverage bits, violations,
  corpus size, the wall split per generation).
* :func:`explain` — for one ``(seed, plan)`` repro key it re-runs the
  schedule with the timeline ring, fleet metrics and history recording
  on (the run kernel on the card, the plain step on a CPU device), then
  interleaves the dispatched-event stream, the injected fault plan, the
  recorded operation history and the checker verdict into a readable
  account of what the seed did. The text equals the JAX package's,
  character for character, for the same arguments.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..engine.convert import field_to_numpy
from ..engine.core import (
    HALT_DONE,
    HALT_IDLE,
    HALT_RUNNING,
    HALT_TIME_LIMIT,
    MET_HALT_CODE,
    METRIC_NAMES,
    STATE_FIELDS,
    make_init,
    make_run_while,
    resolve_device,
)
from .timeline import decode_timeline

__all__ = ["JsonlSink", "explain", "explain_diff"]


class JsonlSink:
    """Append-mode JSONL writer usable as an ``explore.run`` telemetry
    callable: ``sink(record_dict)`` writes one line and flushes PER
    RECORD, so a crashed or killed campaign still leaves every
    completed generation's record readable — a flight recorder that
    loses its tail on crash is not one. ``fsync=True`` additionally
    forces each record to stable storage (``os.fsync``): survives the
    whole BOX dying, at a per-record syscall cost — opt in for
    multi-hour hunts whose telemetry is the only evidence.
    """

    def __init__(self, path_or_file, fsync: bool = False):
        if hasattr(path_or_file, "write"):
            self._fh = path_or_file
            self._own = False
        else:
            self._fh = open(path_or_file, "a")
            self._own = True
        self._fsync = fsync

    def __call__(self, record: dict) -> None:
        self._fh.write(json.dumps(record, sort_keys=True) + "\n")
        self._fh.flush()
        if self._fsync:
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self._own:
            self._fh.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_HALT_STORY = {
    HALT_RUNNING: "still running when the step budget ended",
    HALT_DONE: "halted: the workload completed its scenario",
    HALT_TIME_LIMIT: "halted: the configured time limit tripped",
    HALT_IDLE: "deadlocked: the event pool ran empty with the seed "
               "unhalted (nothing pending, nothing ever will be)",
}

# history `ok` convention (check.history): -1 invoke, 1 ok, 0 failed
_OK_STORY = {-1: "invoke", 1: "ok", 0: "failed"}


def _plan_rows_for(plan, seed):
    """Compile whatever plan form the caller holds into one-seed rows."""
    from ..chaos.plan import LiteralPlan, stack_plan_rows

    if isinstance(plan, LiteralPlan):
        return stack_plan_rows([plan]), plan.slots, plan.uses_dup(), plan
    # a FaultPlan space: literalize for the exact trajectory + pretty
    # printing, then compile the literal (identical rows by contract)
    lit = plan.literalize(int(seed))
    return stack_plan_rows([lit]), lit.slots, lit.uses_dup(), lit


# built-run cache: explain/explain_diff re-run over the same (workload,
# config, caps) — a diff is two captures, a forensics session many — so
# the (init, run) pair is built once. Keyed on id(wl) (workload closures
# aren't hashable), so hold ONE workload object across captures to hit
# it; bounded FIFO so a sweep over many (wl, cfg) pairs cannot grow
# memory unboundedly.
_CAPTURE_CACHE: dict = {}
_CAPTURE_CACHE_MAX = 8


def _capture(wl, cfg, seed, plan, max_steps, timeline_cap, latency=None, causal=False,
             device=None):
    """Re-run one (seed, plan) with the forensics taps on: a field-name
    view dict of the final state (numpy, the JAX package's dtypes) plus
    the literalized plan (or None)."""
    dev = resolve_device(device)
    seeds = np.asarray([seed], np.uint64)
    if plan is not None:
        rows, slots, dup, lit = _plan_rows_for(plan, seed)
    else:
        rows, slots, dup, lit = None, 0, False, None
    key = (id(wl), cfg.hash(), max_steps, timeline_cap, slots, dup, latency, causal, str(dev))
    if key not in _CAPTURE_CACHE:
        while len(_CAPTURE_CACHE) >= _CAPTURE_CACHE_MAX:
            _CAPTURE_CACHE.pop(next(iter(_CAPTURE_CACHE)))
        _CAPTURE_CACHE[key] = (
            make_init(wl, cfg, device=dev, plan_slots=slots, metrics=True,
                      timeline_cap=timeline_cap, latency=latency, causal=causal),
            make_run_while(wl, cfg, max_steps, dup_rows=dup, metrics=True,
                           timeline_cap=timeline_cap, latency=latency, causal=causal),
            wl,  # keep the workload alive so id() stays unique
        )
    init, run, _wl = _CAPTURE_CACHE[key]
    out = run(init(seeds, rows) if rows is not None else init(seeds))
    view = {f: field_to_numpy(f, getattr(out, f)) for f in STATE_FIELDS}
    return view, lit


def explain(
    wl,
    cfg,
    seed: int,
    plan=None,
    invariant=None,
    history_invariant=None,
    max_steps: int = 1000,
    timeline_cap: int = 1024,
    layout: str | None = None,
    max_events: int = 200,
    latency=None,
    causal: bool = False,
    device=None,
) -> str:
    """Narrate one ``(seed, plan)`` run: timeline + history + verdict.

    ``plan`` is a chaos ``LiteralPlan`` (a corpus entry's exact form) or
    ``FaultPlan`` (literalized for this seed), or None for a plain
    seeded run. ``invariant`` / ``history_invariant`` follow the
    ``search_seeds`` contract and become the verdict lines; without
    either the narrative reports the run without judging it.
    ``max_events`` bounds the printed timeline (the middle is elided;
    the head establishes context, the tail holds the crash site).
    ``latency`` (an ``engine.LatencySpec``) re-runs with the
    tail-latency tap on and adds the latency section: per-window
    percentiles off the seed's own sketch plus the slowest completed
    ops — the narrative an SLO breach needs.
    ``causal=True`` re-runs with the provenance columns on and narrates
    the backward happens-before **cone** of the violation instead of
    the whole stream (``obs.causal.causal_slice`` anchored at the last
    failed history record, else the last record, else the final
    dispatch): only the events that can have influenced the anchor,
    each with its seq/Lamport-clock/parent lineage, plus the injected
    fault windows inside the cone.
    ``layout`` is accepted for the JAX package's signature and changes
    nothing (the port has one lowering of the step). ``device`` is where
    the capture runs: the card unless the caller asks for the CPU.
    """
    del layout
    view, lit = _capture(
        wl, cfg, seed, plan, max_steps, timeline_cap, latency, causal, device,
    )

    lines = [
        f"=== explain: {wl.name!r} seed {int(seed)} "
        f"config_hash={cfg.hash()}"
        + (f" plan_hash={lit.hash()}" if lit is not None else ""),
    ]
    if lit is not None:
        lines.append("--- injected fault plan:")
        mask = lit._mask()
        for e, on in zip(lit.events, mask):
            if on:
                lines.append(f"    {e}")

    # merge the dispatched-event stream with the history records by
    # time; records carry an indented `*` marker under their dispatch
    events = decode_timeline(view, wl, 0)
    hist_n = int(view["hist_count"][0]) if view["hist_word"].shape[1] else 0
    hist = [
        (
            int(view["hist_t"][0][i]),
            tuple(int(x) for x in view["hist_word"][0][i]),
        )
        for i in range(hist_n)
    ]
    if causal:
        # the cone narration replaces the whole-stream section: only
        # the events that happens-before-precede the violation anchor
        lines.extend(_cone_section(events, hist, view, wl, max_events))
    else:
        merged = []
        hi = 0
        for e in events:
            merged.append(("ev", e))
            while hi < len(hist) and hist[hi][0] <= e.time_ns:
                merged.append(("rec", hist[hi]))
                hi += 1
        merged.extend(("rec", h) for h in hist[hi:])

        lines.append(
            f"--- timeline ({len(events)} dispatched events, "
            f"{hist_n} history records"
            + (f", {int(view['tl_drop'][0])} DROPPED at ring capacity"
               if int(view["tl_drop"][0]) else "")
            + "):"
        )
        shown = merged
        if len(merged) > max_events:
            head = max_events // 3
            tail = max_events - head
            shown = (
                merged[:head]
                + [("gap", len(merged) - max_events)]
                + merged[-tail:]
            )
        for tag, item in shown:
            if tag == "gap":
                lines.append(f"    ... {item} rows elided ...")
            elif tag == "ev":
                lines.append(f"  {_fmt_event(item, wl)}")
            else:
                t, (op, key, arg, client, ok) = item
                lines.append(
                    f"  [{t / 1e6:>10.3f}ms]   * history: op{op} key={key} "
                    f"arg={arg} client=n{client} "
                    f"{_OK_STORY.get(ok, f'ok={ok}')}"
                )

    met = view["met"][0]
    code = int(met[MET_HALT_CODE])
    lines.append(f"--- outcome: {_HALT_STORY.get(code, f'halt code {code}')}")
    lines.append(
        "    "
        + ", ".join(
            f"{name}={int(met[m])}"
            for m, name in enumerate(METRIC_NAMES)
            if name != "halt_code" and int(met[m])
        )
    )
    if int(view["overflow"][0]):
        lines.append(
            f"    WARNING: {int(view['overflow'][0])} event(s) dropped to "
            f"pool overflow — this run's evidence is unreliable"
        )
    if view["hist_word"].shape[1] and int(view["hist_drop"][0]):
        lines.append(
            f"    WARNING: {int(view['hist_drop'][0])} history record(s) "
            f"dropped — checker verdicts are void for this seed"
        )

    if latency is not None and view["lat_hist"].shape[2]:
        lines.extend(_latency_section(view, latency))

    verdicts = []
    if invariant is not None:
        ok = bool(np.asarray(invariant(view))[0])
        verdicts.append(("final-state invariant", ok))
    if history_invariant is not None:
        from ..check.history import BatchHistory

        hok = bool(np.asarray(history_invariant(BatchHistory.from_view(view)))[0])
        verdicts.append(("history invariant", hok))
    for what, ok in verdicts:
        verdict = "HOLDS" if ok else "VIOLATED"
        lines.append(f"--- verdict: {what} {verdict}")
    if not verdicts:
        lines.append("--- verdict: no invariant supplied (narrative only)")
    lines.append(
        f"--- repro: seed={int(seed)} config_hash={cfg.hash()}"
        + (f" plan_hash={lit.hash()}" if lit is not None else "")
        + f" trace={int(view['trace'][0]):#018x}"
    )
    return "\n".join(lines)


def _latency_section(view, latency) -> list:
    """The tail-percentile narrative of one seed's sketch columns."""
    from ..engine.core import lat_bucket_hi
    from .latency import hist_quantile_bucket

    inv = view["lat_inv"][0]
    resp = view["lat_resp"][0]
    hist = view["lat_hist"][0]  # (P, B)
    invoked = int((inv >= 0).sum())
    completed = int(view["lat_count"][0])
    lines = [
        f"--- latency: {invoked} op(s) invoked, {completed} completed, "
        f"{invoked - completed} never answered"
        + (f", {int(view['lat_drop'][0])} marker(s) DROPPED "
           f"(op id out of range)" if int(view["lat_drop"][0]) else "")
    ]
    for p in range(hist.shape[0]):
        h = hist[p]
        n = int(h.sum())
        if not n:
            continue
        qs = []
        for q in (0.50, 0.90, 0.99):
            b = int(hist_quantile_bucket(h, q))
            qs.append(f"p{int(q * 100)}<={int(lat_bucket_hi(b)) / 1e6:.2f}ms")
        t0 = p * latency.phase_ns / 1e6
        lines.append(
            f"    window [{t0:.0f}ms..): {n} ops, " + ", ".join(qs)
        )
    done = np.flatnonzero((inv >= 0) & (resp >= 0))
    if done.size:
        d = (resp[done] - inv[done]).astype(np.int64)
        worst = done[np.argsort(d)[::-1][:5]]
        tops = ", ".join(
            f"op{int(i)}={int(resp[i] - inv[i]) / 1e6:.2f}ms" for i in worst
        )
        lines.append(f"    slowest completed: {tops}")
    return lines


def _cone_section(events, hist, view, wl, max_events) -> list:
    """The ``explain(causal=True)`` timeline section: anchor selection
    plus the happens-before cone narration (obs/causal.py)."""
    from .causal import causal_slice, format_cone

    failed = [h for h in hist if h[1][4] == 0]
    if failed:
        t, (op, key, arg, client, _ok) = failed[-1]
        anchor, what = (t, client), (
            f"last FAILED history record (op{op} key={key} client=n{client} "
            f"at {t / 1e6:.3f}ms)"
        )
    elif hist:
        t, (op, key, arg, client, _ok) = hist[-1]
        anchor, what = (t, client), (
            f"last history record (op{op} client=n{client} "
            f"at {t / 1e6:.3f}ms)"
        )
    else:
        anchor, what = None, "final dispatch (no history records)"
    lines = [f"--- causal anchor: {what}"]
    if int(view["tl_drop"][0]):
        lines.append(
            f"    WARNING: {int(view['tl_drop'][0])} event(s) dropped at "
            f"ring capacity — the cone's ancestry is prefix-only"
        )
    cone = causal_slice(events, seed=0, anchor=anchor)
    lines.append(format_cone(cone, wl, max_events=max_events))
    return lines


def _fmt_event(e, wl) -> str:
    origin = "timer" if e.src < 0 else f"node{e.src}"
    argstr = ",".join(str(a) for a in e.args)
    return (
        f"[{e.time_ns / 1e6:>10.3f}ms] node{e.node} <- "
        f"{e.kind_name(wl)}({argstr}) from {origin}"
    )


def _row_key(e) -> tuple:
    return (e.time_ns, e.kind, e.node, e.src, tuple(e.args), tuple(e.pay))


def _edge_divergence(ev_a, ev_b, wl) -> list:
    """Name the first causal edge the two runs attribute differently.

    Over the common prefix the per-seed dispatch seqs coincide row for
    row, so comparing raw ``parent`` values IS comparing edges in the
    two derivation DAGs — the first mismatch is the fork, and it can
    sit at a row whose (time, kind, node, args) tuple is still
    identical on both sides (same event, different emitter)."""
    from .causal import derive_parents, parent_class

    pa, pb = derive_parents(ev_a), derive_parents(ev_b)

    def _edge(evs, parents, i):
        e = evs[i]
        if e.parent < 0:
            return f"seq {e.seq} <- {parent_class(e.parent)} row"
        j = parents[i]
        via = (
            _fmt_event(evs[j], wl) if j is not None
            else "(emitter outside the captured ring)"
        )
        return f"seq {e.seq} <- seq {e.parent}  {via}"

    for i in range(min(len(ev_a), len(ev_b))):
        if ev_a[i].parent != ev_b[i].parent:
            return [
                f"--- first divergent causal edge: row {i}",
                f"    clean:     {_edge(ev_a, pa, i)}",
                f"    violating: {_edge(ev_b, pb, i)}",
            ]
    return [
        "--- causal edges identical over the common "
        f"{min(len(ev_a), len(ev_b))}-row prefix"
    ]


def explain_diff(
    wl,
    cfg,
    clean,
    violating,
    invariant=None,
    history_invariant=None,
    max_steps: int = 1000,
    timeline_cap: int = 1024,
    layout: str | None = None,
    context: int = 6,
    causal: bool = False,
    device=None,
) -> str:
    """Localize where a violating run departs from a clean sibling.

    ``clean`` / ``violating`` are ``(seed, plan)`` pairs (plan None for
    a bare seeded run) — typically two children of the same corpus
    parent, one admitted clean and one violating (``explore``'s
    frontier breeding makes such siblings abundant). Both are re-run
    with the timeline ring on; the narrative prints the **first
    divergent timeline row** (compared over the captured ``tl_t`` /
    ``tl_meta`` / ``tl_args`` / ``tl_pay`` columns — the exact tuples
    the trace hash folds, so "row k diverges" is a certified
    statement, not a heuristic), a window of common context before it,
    and each side's continuation plus verdict. Identical streams are
    reported as such — then the divergence is in final state only.

    ``causal=True`` captures both runs with the provenance columns on
    and names the first divergent causal **edge** as well: the first
    row whose parent attribution differs between the runs — which can
    precede the first divergent row tuple (two schedules can dispatch
    the same (time, kind, node, args) event from *different* emitting
    dispatches), and is the actual fork in the derivation DAG.
    ``layout`` and ``device`` as in :func:`explain`.
    """
    del layout
    (seed_a, plan_a), (seed_b, plan_b) = clean, violating
    view_a, lit_a = _capture(
        wl, cfg, seed_a, plan_a, max_steps, timeline_cap, causal=causal, device=device,
    )
    view_b, lit_b = _capture(
        wl, cfg, seed_b, plan_b, max_steps, timeline_cap, causal=causal, device=device,
    )
    ev_a = decode_timeline(view_a, wl, 0)
    ev_b = decode_timeline(view_b, wl, 0)

    def _key(side, seed, lit):
        return (
            f"seed={int(seed)}"
            + (f" plan={lit.hash()}" if lit is not None else "")
            + f" trace={int(side['trace'][0]):#018x}"
        )

    lines = [
        f"=== explain-diff: {wl.name!r} config_hash={cfg.hash()}",
        f"    clean:     {_key(view_a, seed_a, lit_a)}",
        f"    violating: {_key(view_b, seed_b, lit_b)}",
    ]
    for tag, lit in (("clean", lit_a), ("violating", lit_b)):
        if lit is not None:
            on = [e for e, m in zip(lit.events, lit._mask()) if m]
            lines.append(f"--- {tag} plan ({len(on)} events):")
            lines.extend(f"    {e}" for e in on)

    div = None
    for i in range(min(len(ev_a), len(ev_b))):
        if _row_key(ev_a[i]) != _row_key(ev_b[i]):
            div = i
            break
    if div is None and len(ev_a) != len(ev_b):
        div = min(len(ev_a), len(ev_b))

    for side in (view_a, view_b):
        if int(side["tl_drop"][0]):
            lines.append(
                f"    WARNING: {int(side['tl_drop'][0])} event(s) dropped "
                f"at ring capacity — divergence index is prefix-only"
            )

    if div is None:
        lines.append(
            f"--- timelines IDENTICAL over {len(ev_a)} dispatched events "
            f"(divergence, if any, is outside the captured stream)"
        )
    else:
        lines.append(
            f"--- first divergent timeline row: {div} "
            f"(of {len(ev_a)} clean / {len(ev_b)} violating events)"
        )
        lo = max(div - context, 0)
        if lo > 0:
            lines.append(f"    ... {lo} identical rows elided ...")
        for i in range(lo, div):
            lines.append(f"    ={i:>5}  {_fmt_event(ev_a[i], wl)}")
        for tag, evs in (("clean", ev_a), ("violating", ev_b)):
            lines.append(f"  {tag} continues:")
            if div >= len(evs):
                lines.append("        (stream ends)")
            for i in range(div, min(div + context, len(evs))):
                lines.append(f"    {tag[0]}{i:>5}  {_fmt_event(evs[i], wl)}")

    if causal:
        lines.extend(_edge_divergence(ev_a, ev_b, wl))

    for tag, side in (("clean", view_a), ("violating", view_b)):
        met = side["met"][0]
        code = int(met[MET_HALT_CODE])
        lines.append(
            f"--- {tag} outcome: "
            f"{_HALT_STORY.get(code, f'halt code {code}')}"
        )
        verdicts = []
        if invariant is not None:
            verdicts.append(
                ("final-state invariant", bool(np.asarray(invariant(side))[0]))
            )
        if history_invariant is not None:
            from ..check.history import BatchHistory

            verdicts.append((
                "history invariant",
                bool(np.asarray(
                    history_invariant(BatchHistory.from_view(side))
                )[0]),
            ))
        for what, ok in verdicts:
            lines.append(
                f"    {what}: {'HOLDS' if ok else 'VIOLATED'}"
            )
    return "\n".join(lines)
