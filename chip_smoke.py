"""Smoke run of the torch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path — 5-node raft leader election batched over
seeds (``madsim_tpu_torch``) — through the hand-written CUDA run kernel
and holds it against the plain eager step:

1. the card's name and power limit, torch and CUDA versions;
2. builds the run kernel from ``madsim_tpu_torch/csrc`` with nvcc;
3. the ``entry()`` shape (pool 128, loss 0.02, 1,024 seeds):
   ``make_step`` and a 60-step ``make_run`` through the kernel, every
   field equal to the plain step on the card;
4. the full-width bench shape (``BENCH_SPECS["raft"]``: 65,536 seeds,
   ``make_run_while`` capped at 600 steps): the main path, with the
   kernel's launch count read around it; every field equal to the plain
   step on the card, and the first 256 seeds equal to the plain step on
   the CPU; no pool overflow, every seed halted; kernel and plain times
   by CUDA events;
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
# threefry blocks per raft step in the step's batched lane block:
# poll cost, K+1 = 7 per-emit latency/loss lanes, the user timeout lane
RAFT_BLOCKS_PER_STEP = 9
# per pool slot of the pop scan: the valid test, the compare, the select
POP_OPS_PER_SLOT = 3


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


def run_phases(device, entry_seeds: int, bench_seeds: int, cpu_sample: int,
               repeats: int) -> dict:
    """Phases 3 and 4 on ``device``; returns the numbers of the kernel
    line. On the CPU the runners take the plain step throughout, which
    rehearses this script's logic without a card."""
    from madsim_tpu_torch.engine import (
        STATE_FIELDS, EngineConfig, make_init, make_run, make_run_plain,
        make_run_while, make_run_while_plain, make_step, make_step_plain,
    )
    from madsim_tpu_torch.engine.fused import KERNEL, KERNEL_FIELDS, halt_counts
    from madsim_tpu_torch.models import BENCH_SPECS, make_raft

    wl = make_raft()
    # ---- 3. the entry() shape ----
    cfg = EngineConfig(pool_size=128, loss_p=0.02)
    log(f"[3] entry shape: raft, pool 128, loss 0.02, {entry_seeds} seeds")
    st = make_init(wl, cfg, device=device)(np.arange(entry_seeds, dtype=np.uint64))
    assert_equal(make_step(wl, cfg)(st), make_step_plain(wl, cfg)(st),
                 "make_step (kernel, 1 step) vs plain")
    entry_k = make_run(wl, cfg, 60)(st)
    entry_p = make_run_plain(wl, cfg, 60)(st)
    assert_equal(entry_k, entry_p, "make_run 60 steps (kernel) vs plain")
    err = max_abs_err(entry_k, entry_p)

    # ---- 4. the full-width bench shape: the main path ----
    factory, kw, _n, cap = BENCH_SPECS["raft"]
    wl, cfg = factory(), EngineConfig(**kw)
    log(f"[4] bench shape: raft {kw}, {bench_seeds} seeds, make_run_while cap {cap}")
    init = make_init(wl, cfg, device=device)
    st = init(np.arange(bench_seeds, dtype=np.uint64))
    run = make_run_while(wl, cfg, cap)
    if device.type == "cuda":
        torch.cuda.synchronize()
    KERNEL.launches = 0
    out = run(st)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = KERNEL.launches
    log(f"  main path: run kernel launched {launches} times")

    # correctness of what came out
    n_steps = int(out.step[0])
    if not bool((out.step == n_steps).all()):
        raise AssertionError("seeds disagree on the step count")
    if int(out.overflow.max()) != 0:
        raise AssertionError(f"pool overflow: {int(out.overflow.sum())} events dropped")
    if not bool(out.halted.all()):
        raise AssertionError(f"{int((~out.halted).sum())} seeds did not halt")
    if not bool((out.halt_time > 0).all()):
        raise AssertionError("a halted seed has no election latency")
    log(f"  {bench_seeds} seeds halted after {n_steps} steps; overflow 0; "
        f"median election latency {float(out.halt_time.double().median()) / 1e6:.3f} ms")
    plain = make_run_while_plain(wl, cfg, cap)
    ref = plain(st)
    assert_equal(out, ref, "make_run_while (kernel) vs plain on the card")
    err = max(err, max_abs_err(out, ref))
    cpu_st = init(np.arange(cpu_sample, dtype=np.uint64)).to("cpu")
    cpu_ref = make_run_plain(wl, cfg, n_steps)(cpu_st)
    head = type(out)(**{f: getattr(out, f)[:cpu_sample] for f in STATE_FIELDS})
    assert_equal(head, cpu_ref, f"first {cpu_sample} seeds (kernel) vs plain on the CPU")
    err = max(err, max_abs_err(head, cpu_ref))

    # timing: the main path through the kernel, and the plain step
    ms = time_ms(lambda: run(st), repeats, device)
    plain_ms = time_ms(lambda: plain(st), 2, device)
    med = statistics.median(ms)
    sim_s = float(out.now.double().sum()) / 1e9
    log(f"  kernel ms over {repeats} runs: median {med:.4f}, min {min(ms):.4f}, "
        f"max {max(ms):.4f}, all {[round(x, 4) for x in ms]}")
    log(f"  plain ms: {[round(x, 2) for x in plain_ms]}")
    if device.type == "cuda":
        # where the kernel path's time goes: the state copy the wrapper
        # makes, plus the run-to-halt pass; the rest is the drain pass
        copy = time_ms(lambda: type(st)(**{f: getattr(st, f).clone() for f in STATE_FIELDS}),
                       repeats, device)
        pass1 = time_ms(lambda: halt_counts(wl, cfg, cap, st), repeats, device)
        c, p1 = statistics.median(copy), statistics.median(pass1)
        log(f"  breakdown (medians): state copy {c:.4f} ms, run-to-halt pass "
            f"{p1 - c:.4f} ms, drain pass and the rest {statistics.median(ms) - p1:.4f} ms")
    log(f"  simulated seconds {sim_s:.3f}: {sim_s / (med / 1e3):.1f} sim_s/s "
        f"(kernel), {sim_s / (statistics.median(plain_ms) / 1e3):.1f} sim_s/s (plain)")
    log(f"  state holds {state_bytes(st)} bytes ({state_bytes(st) / bench_seeds:.1f} per seed)")

    # the bound: state bytes in and out once, and the step's integer work
    # over the seed-steps this run's seeds need to halt
    in_bytes = sum(getattr(st, f).nbytes for f in KERNEL_FIELDS)
    written = [f for f in KERNEL_FIELDS if f not in ("seed", "slow")]
    out_bytes = sum(getattr(out, f).nbytes for f in written)
    if device.type == "cuda":
        seed_steps = int(halt_counts(wl, cfg, cap, st).sum())
    else:  # rehearsal: no per-seed counts without the kernel
        seed_steps = n_steps * bench_seeds
    e = cfg.pool_size
    ops = seed_steps * (RAFT_BLOCKS_PER_STEP * THREEFRY_OPS + POP_OPS_PER_SLOT * e)
    return dict(
        launches=launches, err=err, ms=med, ms_all=ms,
        plain_ms=statistics.median(plain_ms), in_bytes=in_bytes,
        out_bytes=out_bytes, ops=ops, seed_steps=seed_steps,
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from madsim_tpu_torch.engine.fused import build_library
    from madsim_tpu_torch.models import BENCH_SPECS

    device = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t = time.perf_counter()
    path, build_log = build_library()
    log(f"[2] run kernel built in {time.perf_counter() - t:.1f} s: {path}")
    for line in build_log.splitlines():
        if "registers" in line or "Function properties" in line or "bytes stack" in line:
            log(f"  {line.strip()}")

    _f, _kw, bench_seeds, _cap = BENCH_SPECS["raft"]
    r = run_phases(device, ENTRY_SEEDS, bench_seeds, CPU_SAMPLE, REPEATS)
    if r["launches"] < 1:
        raise AssertionError("the main path never launched the run kernel")
    if r["err"] != 0:
        raise AssertionError(f"kernel disagrees with the plain step: {r['err']}")
    bytes_ms = (r["in_bytes"] + r["out_bytes"]) / HBM_BYTES_PER_S * 1e3
    ops_ms = r["ops"] / (INT32_LANES * max_sm_clock_hz()) * 1e3
    log(f"  bound: bytes {r['in_bytes']} + {r['out_bytes']} -> {bytes_ms:.5f} ms; "
        f"{r['seed_steps']} seed-steps, {r['ops']} int32 ops -> {ops_ms:.5f} ms")
    kernels = {"kernels": [{
        "name": "make_run_fused",
        "route": "cuda",
        "source": "madsim_tpu_torch/csrc/run_kernel.cu",
        "replaces": "madsim_tpu/engine/vmem.py:110",
        "replaces_fn": "engine/vmem.py:make_run_vmem",
        "launches": r["launches"],
        "max_abs_err": r["err"],
        "max_abs_diff": r["err"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}
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
