"""Pipelined device campaigns: dispatch ahead, consume behind.

Port of ``madsim_tpu/farm/pipeline.py``. ``explore.run_device`` is a
strictly alternating loop — dispatch one generation, wait for its
admission summary, do host work (telemetry, checkpoint serialization),
dispatch the next. CUDA launches are asynchronous, so every millisecond
of that host work is a millisecond the card sits idle: the next
generation's program and inputs are already known (the carry is a
device value, the generation index and root key are host scalars).

:func:`run_pipelined` is the SAME campaign on an overlapped schedule —
a depth-``depth`` (default 2) double buffer:

    enqueue g, g+1                      # call_async, no barrier
    loop: wait for g's summary event    # the ONE consume-point sync
          consume g (telemetry, checkpoint) while the card runs g+1
          enqueue g+2

On one CUDA stream a plain ``.tolist()`` of generation g's summary, or a
checkpoint's ``.cpu()`` of its corpus rows, would wait for g+1 too (it is
queued behind it), serializing the pipeline. So each dispatch copies its
summary, its fleet totals and, when the campaign checkpoints, the
coverage map and the store rows the generation may have admitted
``non_blocking`` into pinned host buffers right after the generation's
work, and records a CUDA event behind the copies
(``explore.device._HostCopy``); the consume point waits on that event
and nothing else, and the checkpoint reads host memory alone.
``explore.device.strict_syncs`` turns any other wait into an error.

Bit-identity with the blocking driver is the hard invariant: both
drivers run the identical cached generation programs
(``explore.device._CampaignSession``) with draw keys addressed by
absolute generation index, so the corpus, coverage map, violations and
every checkpoint are bit-for-bit equal — the schedule moves WHEN the
host observes a generation, never WHAT the generation computes.

The one speculative choice is the uniform-vs-breed program for a
generation whose predecessors have not been consumed yet: the corpus
count never decreases, so the pipeline predicts *breed* whenever
admissions are in flight. A misprediction (possible only when a whole
generation admitted nothing into an empty corpus) is detected at the
consume point and repaired by re-dispatching from the pre-generation
carry — the generation programs are pure functions of ``(carry, g, root
key)``, so the discarded speculative execution costs wall clock, never
correctness (``respeculations`` in the campaign_end record counts them).

The wall split makes the overlap measurable: ``queue_wall_s`` is host
time spent enqueueing dispatches, ``idle_wall_s`` is host time blocked
at the consume point waiting for the card.
"""

from __future__ import annotations

import time as _time

from ..explore.device import _SUMMARY, _CampaignSession, _counted_total
from ..explore.driver import ExploreReport

__all__ = ["run_pipelined"]


def run_pipelined(
    wl,
    cfg,
    space,
    *,
    invariant=None,
    depth: int = 2,
    generations: int = 8,
    batch: int = 256,
    root_seed: int = 0,
    max_steps: int = 1000,
    cov_words: int = 32,
    layout: str | None = None,
    require_halt: bool = False,
    seed_corpus=(),
    select_top: int = 32,
    max_corpus: int = 4096,
    max_ops: int = 3,
    inherit_seed_p: float = 0.75,
    log=None,
    cov_hitcount: bool = False,
    telemetry=None,
    resume=None,
    checkpoint_path: str | None = None,
    latency=None,
    metrics: bool = False,
    mesh=None,
    viol_cap: int | None = None,
    pool_index: bool | None = None,
    history_check=None,
    causal: bool = False,
    device=None,
) -> ExploreReport:
    """``explore.run_device`` on a depth-``depth`` pipelined schedule.

    Same contract, same arguments (plus ``depth``), bit-identical
    outcomes — corpus, coverage map, violations, checkpoints and replay
    keys all match the blocking driver (module docstring). ``depth=1``
    degenerates to the blocking schedule and exists for A/B sanity.

    Telemetry differences, by design: ``generation`` records carry the
    measured ``queue_wall_s``/``idle_wall_s`` split (the blocking driver
    writes zeros), ``dispatch_wall_s`` is their sum, and the
    ``campaign_end`` record adds ``respeculations`` (discarded
    speculative dispatches). The schedule waits for the card once a
    generation, at the consume point: under
    ``explore.device.counted_syncs`` each generation's ``host_syncs`` is
    the profiler's count of it (whose own end makes the schedule a
    blocking one), else None; nothing in the dispatch path waits for the
    card.
    """
    if depth < 1:
        raise ValueError("need pipeline depth >= 1")
    sess = _CampaignSession(
        wl, cfg, space, invariant=invariant, generations=generations,
        batch=batch, root_seed=root_seed, max_steps=max_steps,
        cov_words=cov_words, layout=layout, require_halt=require_halt,
        seed_corpus=seed_corpus, select_top=select_top,
        max_corpus=max_corpus, max_ops=max_ops,
        inherit_seed_p=inherit_seed_p, log=log, cov_hitcount=cov_hitcount,
        telemetry=telemetry, resume=resume,
        checkpoint_path=checkpoint_path, latency=latency, metrics=metrics,
        mesh=mesh, viol_cap=viol_cap, pool_index=pool_index,
        history_check=history_check, causal=causal, device=device,
    )
    sess.log_label = "pipelined"
    sess.start("device-pipelined", pipeline_depth=depth)

    wall_queue = 0.0
    wall_idle = 0.0
    wall_sync = 0.0
    wall_compile = 0.0
    host_syncs = 0  # consume points, one a generation
    counted = []  # the counted generations' host_syncs
    respeculations = 0
    g_end = sess.g_start + generations
    g_next = sess.g_start
    pending: list = []  # in-flight generations, oldest first

    def _dispatch(g: int, breed: bool) -> dict:
        """Enqueue generation ``g``'s program (no completion barrier) and
        its host copies, and advance the speculative carry chain."""
        nonlocal wall_queue, wall_compile
        t0 = _time.monotonic()  # lint: allow(wall-clock)
        runner = sess.runner(breed)
        carry_before = sess.carry
        carry_after, summary, extras = runner.call_async(
            carry_before, g, sess.rk0, sess.rk1
        )
        copy = sess.host_copy(carry_before, carry_after, summary, extras)
        build = runner.last_build_s
        t1 = _time.monotonic()  # lint: allow(wall-clock)
        sess.carry = carry_after
        queue_s = (t1 - t0) - build
        wall_queue += queue_s
        wall_compile += build
        return dict(
            g=g, breed=breed, carry_before=carry_before,
            copy=copy, queue_s=queue_s, build_s=build,
        )

    while g_next < g_end or pending:
        # the host syncs of the iteration that consumes the oldest
        # generation in flight, its dispatches ahead included
        syncs = sess.generation_syncs(pending[0]["g"] if pending else g_next)
        with syncs.count():
            while g_next < g_end and len(pending) < depth:
                # optimistic mode prediction: the corpus count never
                # decreases, so a known-nonempty corpus means breed for
                # certain; with unconsumed admissions in flight, speculate
                # breed (a generation that admits NOTHING is the only way
                # this is wrong)
                breed = g_next > 0 and (sess.count > 0 or len(pending) > 0)
                pending.append(_dispatch(g_next, breed))
                g_next += 1
            item = pending.pop(0)
            g = item["g"]
            # all generations < g are consumed, so sess.count is exactly the
            # count the blocking driver would see before dispatching g
            actual_breed = g > 0 and sess.count > 0
            if actual_breed != item["breed"]:
                # mispredicted speculation: the programs are pure functions
                # of (carry, g, root key), so discard the speculative chain
                # and recompute from the pre-g carry — wall clock lost,
                # bit-identity kept
                respeculations += 1 + len(pending)
                pending.clear()
                g_next = g + 1
                sess.carry = item["carry_before"]
                item = _dispatch(g, actual_breed)
            t0 = _time.monotonic()  # lint: allow(wall-clock)
            item["copy"].wait()  # THE consume-point sync
            host_syncs += 1
            t1 = _time.monotonic()  # lint: allow(wall-clock)
            s = dict(zip(_SUMMARY, item["copy"].summary.tolist()))
            fleet = sess.fleet(item["copy"].totals)
            t2 = _time.monotonic()  # lint: allow(wall-clock)
            idle = t1 - t0
            sync = t2 - t1
            wall_idle += idle
            wall_sync += sync
            # the per-generation checkpoint snapshots the campaign as of g
            # from g's own host copy (sess.carry has already speculated
            # ahead), so it overlaps the card running g+1 — the whole point
            # of the schedule
            record = sess.consume(g, s, fleet, {
                "dispatch_wall_s": round(item["queue_s"] + idle, 3),
                "compile_wall_s": round(item["build_s"], 3),
                "sync_wall_s": round(sync, 3),
                "queue_wall_s": round(item["queue_s"], 3),
                "idle_wall_s": round(idle, 3),
            }, item["copy"])
        sess.emit_generation(record, syncs)
        counted.append(syncs.host_syncs)

    wall_dispatch = wall_queue + wall_idle
    sess.emit({
        "event": "campaign_end", "generations": g_end,
        "generations_run": generations,
        "sims": sess.sims,
        "cov_bits": sess.curve[-1] if sess.curve else 0,
        "corpus_size": sess.count, "violations": sess.vcount_host,
        "wall_dispatch_s": round(wall_dispatch, 3),
        "wall_sync_s": round(wall_sync, 3),
        "wall_compile_s": round(wall_compile, 3),
        "wall_queue_s": round(wall_queue, 3),
        "wall_idle_s": round(wall_idle, 3),
        "host_syncs": _counted_total(counted),
        "respeculations": respeculations,
    })
    return sess.report(
        wall_dispatch=wall_dispatch, wall_sync=wall_sync,
        wall_compile=wall_compile, host_syncs=host_syncs,
        wall_queue=wall_queue, wall_idle=wall_idle,
    )
