"""Smoke run of the torch port on one NVIDIA card.

    python3 chip_smoke.py                      # the whole run
    python3 chip_smoke.py --groups 4,8,32 [model keys...]
                                               # lanes-per-seed sweep only

Drives the port's main path — 5-node raft leader election batched over
seeds (``madsim_tpu_torch``) — and then every other model family of the
port (the ``BENCH_SPECS`` and ``SOAK_SPECS`` models) through the
hand-written CUDA run and drain kernels, and holds each against the
plain eager step:

1. the card's name and power limit, torch and CUDA versions;
2. builds every model's kernel library from ``madsim_tpu_torch/csrc``
   with nvcc, one process per model, all started together, and prints
   each kernel's registers and stack frame, and per pool its lanes per
   seed (G), seeds per block, shared bytes per block and resident
   blocks per SM (the card's occupancy calculator);
3. the ``entry()`` shape (pool 128, loss 0.02, 1,024 seeds):
   ``make_step`` and a 60-step ``make_run`` through the kernel, every
   field equal to the plain step on the card;
4. the main path, raft at its full-width bench shape
   (``BENCH_SPECS["raft"]``: 65,536 seeds, ``make_run_while`` capped at
   600 steps), then, phases 5-10, every other model at its full-width
   ``BENCH_SPECS`` shape: microbench, pingpong, broadcast, kvchaos,
   kvchaos with the payload arena (the kvchaos config) and raftlog;
   then, phases 11-15, the five families at their full-width
   ``SOAK_SPECS`` shape (the JAX package's soak configurations):
   snapshot, twophase, paxos, leasekv and shardkv.
   Each drives ``make_run_while`` (a run kernel and a drain kernel
   launch) with the launch counts read around it, checks that every
   seed halted with no pool overflow, holds every field against the
   plain step on the card (run once, timed that once, and counting the
   work of the bound) and the first 256 seeds against the plain step on
   the CPU, holds the drain kernel alone against its plain version, and
   times the kernel path by CUDA events (median of 5, min, max). Raft
   also checks its election latency and splits the kernel path's time
   into the run pass, the drain kernel and the rest;
5. one JSON line describing each kernel, then the card's name and power
   limit, then ``{"ok": true, "device": ...}`` as the last line.

Any mismatch or exception exits non-zero. Without a card it exits
non-zero before printing any result. Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ENTRY_SEEDS = 1024
CPU_SAMPLE = 256
REPEATS = 5
# Bound terms (NVIDIA H100 SXM data sheet): 3.35 TB/s of HBM; integer
# issue of 132 SMs x 64 int32 lanes per clock at the card's max clock
HBM_BYTES_PER_S = 3.35e12
INT32_LANES = 132 * 64
# int32 operations per threefry2x32-20 block: 20 rounds of add, rotate,
# xor, 5 key injections of 3 adds, the parity word and the 2 key adds
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2 + 2
# per pool slot of the pop scan: the valid test, the compare, the select
POP_OPS_PER_SLOT = 3


# the model phases, in order: (BENCH_SPECS or SOAK_SPECS name, kernel
# model key, factory keyword arguments); raft, the main path, first
MODEL_PHASES = (
    ("raft", "raft", {}),
    ("microbench", "microbench", {}),
    ("pingpong", "pingpong", {}),
    ("broadcast", "broadcast", {}),
    ("kvchaos", "kvchaos", {}),
    ("kvchaos", "kvchaos-payload", {"payload": True}),
    ("raftlog", "raftlog", {}),
    ("snapshot", "snapshot", {}),
    ("twophase", "twophase", {}),
    ("paxos", "paxos", {}),
    ("leasekv", "leasekv", {}),
    ("shardkv", "shardkv", {}),
)


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    return float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6


def max_abs_err(a, b) -> int:
    """Largest |a - b| over every field of two states, exact in int."""
    from madsim_tpu_torch.engine import STATE_FIELDS

    worst = 0
    for f in STATE_FIELDS:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        if x.shape != y.shape:
            raise AssertionError(f"field {f}: shape {x.shape} vs {y.shape}")
        diff = x != y
        if bool(diff.any()):
            xs = x[diff].to(torch.int64).tolist()
            ys = y[diff].to(torch.int64).tolist()
            worst = max(worst, max(abs(p - q) for p, q in zip(xs, ys)))
    return worst


def assert_equal(a, b, what: str) -> None:
    from madsim_tpu_torch.engine import STATE_FIELDS

    bad = [
        f for f in STATE_FIELDS
        if not torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
    ]
    if bad:
        raise AssertionError(f"{what}: fields differ: {bad}")
    log(f"  {what}: every field equal")


def time_ms(fn, repeats: int, device) -> list:
    """Per-call milliseconds; CUDA events on the card."""
    out = []
    for _ in range(repeats):
        if device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize()
            out.append(t0.elapsed_time(t1))
        else:
            t = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t) * 1e3)
    return out


def state_bytes(st) -> int:
    from madsim_tpu_torch.engine import STATE_FIELDS

    return sum(getattr(st, f).nbytes for f in STATE_FIELDS)


def entry_phase(device, entry_seeds: int) -> int:
    """Phase 3: raft at the ``entry()`` shape, ``make_step`` and a
    60-step ``make_run`` through the kernel against the plain step."""
    from madsim_tpu_torch.engine import (
        EngineConfig, make_init, make_run, make_run_plain, make_step,
        make_step_plain,
    )
    from madsim_tpu_torch.models import make_raft

    wl, cfg = make_raft(), EngineConfig(pool_size=128, loss_p=0.02)
    log(f"[3] entry shape: raft, pool 128, loss 0.02, {entry_seeds} seeds")
    st = make_init(wl, cfg, device=device)(np.arange(entry_seeds, dtype=np.uint64))
    assert_equal(make_step(wl, cfg)(st), make_step_plain(wl, cfg)(st),
                 "make_step (kernel, 1 step) vs plain")
    entry_k = make_run(wl, cfg, 60)(st)
    entry_p = make_run_plain(wl, cfg, 60)(st)
    assert_equal(entry_k, entry_p, "make_run 60 steps (kernel) vs plain")
    return max_abs_err(entry_k, entry_p)


def plain_reference(wl, cfg, cap: int, st):
    """The plain step until every seed has halted, at most ``cap``
    times (the loop of ``make_run_while_plain``), counting on the way
    what the bound needs: the seed-steps taken before each seed halts,
    and those among them that drop a stale event (a dead or restarted
    destination) and so draw no block. A dispatch folds the trace, a
    reschedule keeps the popped slot valid; a drop does neither.
    Returns ``(state, seed_steps, drops)``."""
    from madsim_tpu_torch.engine import make_step_plain

    step = make_step_plain(wl, cfg)
    seed_steps = drops = 0
    i = 0
    while i < cap and not bool(st.halted.all()):
        nxt = step(st)
        live = ~st.halted
        dropped = live & (nxt.trace == st.trace) & (
            nxt.ev_valid.sum(1) == st.ev_valid.sum(1) - 1)
        seed_steps = seed_steps + live.sum()
        drops = drops + dropped.sum()
        st, i = nxt, i + 1
    return st, int(seed_steps), int(drops)


def raft_extras(device, wl, cfg, cap: int, st, out, med: float) -> None:
    """Raft's own checks and split of the kernel path's time."""
    from madsim_tpu_torch.engine.fused import KERNEL, _first_pass, kernel_model

    if not bool((out.halt_time > 0).all()):
        raise AssertionError("a halted seed has no election latency")
    log(f"  median election latency {float(out.halt_time.double().median()) / 1e6:.3f} ms")
    if device.type == "cuda":
        # where the kernel path's time goes: the run pass (the wrapper's
        # allocations and the run kernel), the drain kernel alone, and
        # the rest; no state is copied
        run_ms = time_ms(lambda: _first_pass(wl, cfg, st, cap, True), REPEATS, device)
        spec = kernel_model(wl)
        _spec, first, iters, tmax = _first_pass(wl, cfg, st, cap, True)
        drain_ms = []
        for _ in range(REPEATS):
            x = type(first)(**{**vars(first), "step": first.step.clone(),
                               "ev_valid": first.ev_valid.clone()})
            drain_ms += time_ms(lambda: KERNEL.drain(spec, x, iters, tmax), 1, device)
        r, d = statistics.median(run_ms), statistics.median(drain_ms)
        log(f"  breakdown (medians): run pass {r:.4f} ms, drain kernel {d:.4f} ms, "
            f"the rest {med - r - d:.4f} ms (no state copy)")


def drain_check(wl, cfg, cap: int, st) -> None:
    """The drain kernel alone against its plain version on the card,
    from the run kernel's stop-at-halt outputs: every seed takes its
    ``tmax - iters`` remaining halted steps; ``step`` and ``ev_valid``
    must be equal."""
    from madsim_tpu_torch.engine.fused import KERNEL, _first_pass, drain_plain

    spec, first, iters, tmax = _first_pass(wl, cfg, st, cap, True)
    want_step, want_valid = drain_plain(first.step, first.ev_valid, first.ev_time,
                                        tmax - iters)
    KERNEL.drain(spec, first, iters, tmax)
    if not (torch.equal(first.step, want_step) and torch.equal(first.ev_valid, want_valid)):
        raise AssertionError(f"{spec.key}: the drain kernel disagrees with its plain version")


def model_phase(device, idx: int, spec_name: str, key: str, factory_kw: dict,
                cpu_sample: int, repeats: int, extras=None) -> dict:
    """One model at its full-width BENCH_SPECS (else SOAK_SPECS) shape:
    the main path through the kernel with the launch counts read around
    it, the checks, every field against the plain step (on the device,
    run and timed once, and the first seeds on the CPU), the kernel's
    time and the bound's inputs. ``extras(device, wl, cfg, cap, st, out, ms)``
    adds a model's own checks and timings, given the kernel's median."""
    from madsim_tpu_torch.engine import (
        STATE_FIELDS, EngineConfig, make_init, make_run_plain, make_run_while,
    )
    from madsim_tpu_torch.engine.fused import KERNEL, halt_counts
    from madsim_tpu_torch.models import BENCH_SPECS, SOAK_SPECS

    factory, kw, n_seeds, cap = {**SOAK_SPECS, **BENCH_SPECS}[spec_name]
    wl, cfg = factory(**factory_kw), EngineConfig(**kw)
    log(f"[{idx}] {key}: {kw}, {n_seeds} seeds, make_run_while cap {cap}")
    init = make_init(wl, cfg, device=device)
    st = init(np.arange(n_seeds, dtype=np.uint64))
    run = make_run_while(wl, cfg, cap)
    if device.type == "cuda":
        torch.cuda.synchronize()
    KERNEL.reset()
    out = run(st)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = KERNEL.counts.get(key, 0)
    drains = KERNEL.counts.get(f"{key}/drain", 0)
    log(f"  main path: {key} run kernel launched {launches} times, drain kernel {drains}")

    n_steps = int(out.step[0])
    if not bool((out.step == n_steps).all()):
        raise AssertionError(f"{key}: seeds disagree on the step count")
    if int(out.overflow.max()) != 0:
        raise AssertionError(f"{key}: pool overflow, {int(out.overflow.sum())} events dropped")
    if not bool(out.halted.all()):
        raise AssertionError(f"{key}: {int((~out.halted).sum())} seeds did not halt")
    sends = int((out.msg_count - st.msg_count).sum())
    log(f"  {n_seeds} seeds halted after {n_steps} steps; overflow 0; "
        f"{sends} messages sent; median halt time "
        f"{float(out.halt_time.double().median()) / 1e6:.3f} ms")
    # the plain step's one run: the reference, its time and the counts
    # of the bound
    got = []
    plain_ms = time_ms(lambda: got.append(plain_reference(wl, cfg, cap, st)), 1, device)
    ref, seed_steps, drops = got[0]
    assert_equal(out, ref, "make_run_while (kernel) vs plain on the card")
    err = max_abs_err(out, ref)
    if device.type == "cuda":
        counted = int(halt_counts(wl, cfg, cap, st).sum())
        if counted != seed_steps:
            raise AssertionError(
                f"{key}: the kernel's stop-at-halt pass counts {counted} "
                f"seed-steps, the plain run {seed_steps}")
        drain_check(wl, cfg, cap, st)
        log("  drain kernel alone vs its plain version: step and ev_valid equal")
    k = min(cpu_sample, n_seeds)
    cpu_ref = make_run_plain(wl, cfg, n_steps)(init(np.arange(k, dtype=np.uint64)).to("cpu"))
    head = type(out)(**{f: getattr(out, f)[:k] for f in STATE_FIELDS})
    assert_equal(head, cpu_ref, f"first {k} seeds (kernel) vs plain on the CPU")
    err = max(err, max_abs_err(head, cpu_ref))

    ms = time_ms(lambda: run(st), repeats, device)
    med = statistics.median(ms)
    sim_s = float(out.now.double().sum()) / 1e9
    log(f"  kernel ms over {repeats} runs: median {med:.4f}, min {min(ms):.4f}, "
        f"max {max(ms):.4f}, all {[round(x, 4) for x in ms]}")
    log(f"  plain ms (the one correctness run): {plain_ms[0]:.2f}")
    log(f"  simulated seconds {sim_s:.3f}: {sim_s / (med / 1e3):.1f} sim_s/s "
        f"(kernel), {sim_s / (plain_ms[0] / 1e3):.1f} sim_s/s (plain)")
    log(f"  state holds {state_bytes(st)} bytes ({state_bytes(st) / n_seeds:.1f} per seed)")
    if extras is not None:
        extras(device, wl, cfg, cap, st, out, med)
    return dict(
        launches=launches, drains=drains, err=err, ms=med, ms_all=ms, plain_ms=plain_ms[0],
        **bound_terms(st, out, cfg.pool_size, seed_steps, drops, sends),
    )


def bound_terms(st, out, pool: int, seed_steps: int, drops: int, sends: int) -> dict:
    """The bound's inputs: the state's bytes in and out once, and the
    integer work this run's data needs. Every seed-step before its seed
    halts scans the pool; each of them but a stale drop draws the poll
    block, and every send draws its latency block. The handlers' own
    draws are not counted, so the work term stays a lower bound."""
    from madsim_tpu_torch.engine.fused import KERNEL_FIELDS, READ_ONLY_FIELDS

    in_bytes = sum(getattr(st, f).nbytes for f in KERNEL_FIELDS)
    written = [f for f in KERNEL_FIELDS if f not in READ_ONLY_FIELDS]
    out_bytes = sum(getattr(out, f).nbytes for f in written)
    blocks = seed_steps - drops + sends
    ops = seed_steps * POP_OPS_PER_SLOT * pool + blocks * THREEFRY_OPS
    return dict(in_bytes=in_bytes, out_bytes=out_bytes, ops=ops,
                seed_steps=seed_steps, drops=drops, blocks=blocks)


def launch_shape(spec, pool: int) -> str:
    """G, seeds per block, shared bytes per block and resident blocks
    per SM of a library's run and drain kernels at ``pool``."""
    from madsim_tpu_torch.engine.fused import KERNEL

    o = KERNEL.occupancy(spec, pool)
    return (f"G {o['group']}, {o['seeds_per_block']} seeds per block of 128 threads; "
            f"run kernel {o['run_smem_bytes']} B shared per block, "
            f"{o['run_blocks_per_sm']} blocks per SM; drain kernel "
            f"{o['drain_smem_bytes']} B, {o['drain_blocks_per_sm']} blocks per SM")


def kernel_line(name: str, model_source: str, r: dict, clock_hz: float) -> dict:
    """One entry of the kernels line, with the bound computed here."""
    bytes_ms = (r["in_bytes"] + r["out_bytes"]) / HBM_BYTES_PER_S * 1e3
    ops_ms = r["ops"] / (INT32_LANES * clock_hz) * 1e3
    log(f"  {name} bound: bytes {r['in_bytes']} + {r['out_bytes']} -> {bytes_ms:.5f} ms; "
        f"{r['seed_steps']} seed-steps ({r['drops']} stale drops), {r['blocks']} "
        f"threefry blocks, {r['ops']} int32 ops -> {ops_ms:.5f} ms")
    return {
        "name": name,
        "route": "cuda",
        "source": "madsim_tpu_torch/csrc/run_kernel.cu",
        "model_source": model_source,
        "replaces": "madsim_tpu/engine/vmem.py:110",
        "replaces_fn": "engine/vmem.py:make_run_vmem",
        "launches": r["launches"] + r["drains"],
        "launches_run": r["launches"],
        "launches_drain": r["drains"],
        "max_abs_err": r["err"],
        "max_abs_diff": r["err"],
        "ms": r["ms"],
        "ms_min": min(r["ms_all"]),
        "ms_max": max(r["ms_all"]),
        "plain_ms": r["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def run_variant(spec, wl, cfg, cap: int, st):
    """make_run_while through the library ``spec`` (a registered
    model's library built at another G): the run kernel, then the
    drain kernel."""
    from madsim_tpu_torch.engine.fused import (
        KERNEL, _tables, config_words, fresh_outputs,
    )

    out = fresh_outputs(st)
    iters = torch.empty_like(st.now)
    tmax = torch.empty((1,), dtype=torch.int64, device=st.device)
    KERNEL.launch(spec, st, out, _tables(wl, st.device), iters, tmax,
                  config_words(wl, cfg), cap, True)
    KERNEL.drain(spec, out, iters, tmax)
    return out


def group_sweep(device, groups: list, keys: list) -> None:
    """Time make_run_while at each model's full-width shape with G =
    each of ``groups`` lanes per seed, in turns (the order rotates each
    round), every variant's output equal to the registered library's."""
    import dataclasses

    from madsim_tpu_torch.engine import EngineConfig, make_init, make_run_while
    from madsim_tpu_torch.engine.fused import MODELS, build_libraries
    from madsim_tpu_torch.models import BENCH_SPECS, SOAK_SPECS

    by_key = {m.key: m for m in MODELS.values()}
    variants = {
        (k, g): dataclasses.replace(by_key[k], key=f"{k}-g{g}", group=g)
        for k in keys for g in groups
    }
    t = time.perf_counter()
    build_libraries(variants.values())
    log(f"[sweep] {len(variants)} libraries built in {time.perf_counter() - t:.1f} s")
    phases = {key: (name, kw) for name, key, kw in MODEL_PHASES}
    for key in keys:
        spec_name, factory_kw = phases[key]
        factory, kw, n_seeds, cap = {**SOAK_SPECS, **BENCH_SPECS}[spec_name]
        wl, cfg = factory(**factory_kw), EngineConfig(**kw)
        st = make_init(wl, cfg, device=device)(np.arange(n_seeds, dtype=np.uint64))
        ref = make_run_while(wl, cfg, cap)(st)
        times = {g: [] for g in groups}
        for g in groups:
            assert_equal(run_variant(variants[key, g], wl, cfg, cap, st), ref,
                         f"{key} G={g} vs the registered library")
        for rnd in range(REPEATS):
            order = groups[rnd % len(groups):] + groups[:rnd % len(groups)]
            for g in order:
                spec = variants[key, g]
                times[g] += time_ms(lambda: run_variant(spec, wl, cfg, cap, st), 1, device)
        for g in groups:
            ms = times[g]
            log(f"  {key} G={g}: median {statistics.median(ms):.4f} ms, min {min(ms):.4f}, "
                f"max {max(ms):.4f}; {launch_shape(variants[key, g], cfg.pool_size)}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if "--groups" in sys.argv:
        # python3 chip_smoke.py --groups 4,8,32 [model keys...]: the
        # lanes-per-seed sweep alone
        device = torch.device("cuda")
        log(f"[1] card: {nvidia_smi('name,power.limit')}; torch {torch.__version__}")
        at = sys.argv.index("--groups")
        groups = [int(x) for x in sys.argv[at + 1].split(",")]
        keys = sys.argv[at + 2:] or [key for _n, key, _kw in MODEL_PHASES]
        group_sweep(device, groups, keys)
        return 0
    from madsim_tpu_torch.engine.fused import MODELS, build_libraries

    device = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t = time.perf_counter()
    libs = build_libraries()
    log(f"[2] {len(libs)} run kernel libraries built in {time.perf_counter() - t:.1f} s "
        f"(one nvcc per model, in parallel)")
    for key, (path, build_log) in libs.items():
        log(f"  {key}: {path}")
        for line in build_log.splitlines():
            if "registers" in line or "bytes stack" in line or "Function properties" in line:
                log(f"    {line.strip()}")
        spec = next(m for m in MODELS.values() if m.key == key)
        for pool in spec.pools:
            log(f"    pool {pool}: {launch_shape(spec, pool)}")

    clock = max_sm_clock_hz()
    entry_err = entry_phase(device, ENTRY_SEEDS)
    results = []
    by_key = {m.key: m for m in MODELS.values()}
    for i, (spec_name, key, factory_kw) in enumerate(MODEL_PHASES):
        raft = key == "raft"
        r = model_phase(device, 4 + i, spec_name, key, factory_kw, CPU_SAMPLE,
                        REPEATS, extras=raft_extras if raft else None)
        if raft:
            r["err"] = max(r["err"], entry_err)
        name = "make_run_fused" if raft else f"make_run_fused/{key}"
        results.append((name, f"madsim_tpu_torch/csrc/{by_key[key].header}", r))
    for name, _src, r in results:
        if r["launches"] < 1 or r["drains"] < 1:
            raise AssertionError(f"{name}: the main path did not launch its run and drain kernels")
        if r["err"] != 0:
            raise AssertionError(f"{name}: kernel disagrees with the plain step: {r['err']}")
    kernels = {"kernels": [kernel_line(name, src, r, clock) for name, src, r in results]}
    print(json.dumps(kernels), flush=True)
    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
