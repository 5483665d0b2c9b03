"""Throughput and latency measurement for the batched engine.

Port of ``madsim_tpu/engine/measure.py``. A *dispatch* is ``repeats``
independent seed batches run back to back, each reduced on the device
to three int64 sums (simulated nanoseconds, pool overflows, halted
rows), with no host read until the dispatch ends: long enough that the
per-dispatch overhead is amortised, then the median over a few
dispatches.

Each dispatch is timed on the host clock between two
``torch.cuda.synchronize()`` calls (``perf_counter``; on the CPU the
same code runs without them) and, on a card, also by CUDA events on
the current stream. The returned dicts carry the reference's keys
letter for letter, plus ``device_walls_s`` (or ``device_median_ms``
for :func:`null_dispatch_stats`): the CUDA-event times, ``None`` on the
CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .compact import make_run_compacted
from .core import EngineConfig, Workload, make_init, resolve_device

__all__ = [
    "make_repeat_program",
    "measure_throughput",
    "measure_latency",
    "null_dispatch_stats",
]


def make_repeat_program(
    wl: Workload,
    cfg: EngineConfig,
    max_steps: int,
    n_seeds: int,
    seed_mod: int,
    shrink: int = 4,
    min_size: int = 2048,
    device=None,
):
    """Build ``program(seed_base, repeats) -> (sim_ns, overflow,
    halted)``, three 0-d int64 tensors on the device.

    Runs ``repeats`` batches of ``n_seeds`` seeds (values ``(seed_base +
    r*n_seeds + i) % seed_mod``) through the compacted runner's
    ``compute`` and sums each on the device: total simulated
    nanoseconds, total pool overflow, total halted rows (equal to
    ``repeats*n_seeds`` iff every seed halted). ``seed_mod`` keeps the
    seeds inside the range the config's pool size was verified
    overflow-free for.
    """
    if seed_mod < n_seeds:
        raise ValueError(f"seed_mod={seed_mod} must be >= n_seeds={n_seeds}")
    dev = resolve_device(device)
    init = make_init(wl, cfg, device=dev)
    run = make_run_compacted(
        wl, cfg, max_steps, shrink=shrink, min_size=min_size,
        fields=("now", "overflow", "halted"),
    )
    lanes = torch.arange(n_seeds, dtype=torch.int64, device=dev)

    def program(seed_base: int, repeats: int):
        acc = torch.zeros((3,), dtype=torch.int64, device=dev)
        for r in range(repeats):
            base = (int(seed_base) + r * n_seeds) % seed_mod
            for b in run.compute(init((base + lanes) % seed_mod)):
                acc += torch.stack(
                    [b["now"].sum(), b["overflow"].sum(dtype=torch.int64),
                     b["halted"].sum()]
                )
        return acc[0], acc[1], acc[2]

    return program


def _timed(fn, dev: torch.device):
    """``(host seconds, device seconds or None, fn())``: the host clock
    between two synchronisations, and CUDA events on a card."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    t0 = time.perf_counter()  # lint: allow(wall-clock)
    out = fn()
    if cuda:
        ev1.record()
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0  # lint: allow(wall-clock)
    return wall, (ev0.elapsed_time(ev1) / 1e3 if cuda else None), out


def _calibrate_and_measure(
    program,
    n_seeds: int,
    target_wall_s: float,
    n_measure: int,
    seed_base: int,
    max_repeats: int,
    dev: torch.device,
    cal_repeats: int = 1,
):
    """Warm up, calibrate with one ``cal_repeats`` dispatch, pick
    ``repeats`` to reach ``target_wall_s`` and grow it until a dispatch
    does, then time ``n_measure`` dispatches. Returns ``(repeats,
    cal_wall, walls, device_walls, sims, ovf_tot, halted_min)``."""
    _timed(lambda: program(seed_base, 1), dev)  # builds the kernel library
    cal_wall = _timed(lambda: program(seed_base, cal_repeats), dev)[0]

    repeats = min(
        max(cal_repeats, int(np.ceil(target_wall_s / max(cal_wall / cal_repeats, 1e-9)))),
        max_repeats,
    )
    for _ in range(8):
        sized_wall = _timed(lambda: program(seed_base, repeats), dev)[0]
        if sized_wall >= target_wall_s * 0.6 or repeats >= max_repeats:
            break
        per_rep = sized_wall / repeats
        repeats = min(
            max(repeats + 1, int(np.ceil(target_wall_s / max(per_rep, 1e-9)))),
            max_repeats,
        )

    walls, device_walls, sims, ovf_tot, halted_min = [], [], [], 0, None
    for m in range(n_measure):
        base = seed_base + (m + 1) * repeats * n_seeds
        wall, dwall, (sim_ns, ovf, halted) = _timed(lambda: program(base, repeats), dev)
        walls.append(wall)
        device_walls.append(dwall)
        sims.append(int(sim_ns) / 1e9)
        ovf_tot += int(ovf)
        h = int(halted)
        halted_min = h if halted_min is None else min(halted_min, h)
    if dev.type != "cuda":
        device_walls = None
    return repeats, cal_wall, walls, device_walls, sims, ovf_tot, halted_min


def measure_throughput(
    wl: Workload,
    cfg: EngineConfig,
    max_steps: int,
    n_seeds: int,
    target_wall_s: float = 5.0,
    n_measure: int = 5,
    seed_base: int = 0,
    seed_mod: int = 131072,
    max_repeats: int = 4096,
    shrink: int = 4,
    min_size: int = 2048,
    device=None,
) -> dict:
    """Simulated seconds per second, over ``n_measure`` dispatches of
    at least ``target_wall_s`` each: the median rate with its min, max
    and spread, every dispatch's wall, the repeat count, and the
    correctness counters (``overflow`` must be 0 and ``all_halted``
    True for the rate to be quotable; callers check)."""
    dev = resolve_device(device)
    program = make_repeat_program(
        wl, cfg, max_steps, n_seeds, seed_mod, shrink, min_size, device=dev
    )
    repeats, cal_wall, walls, dwalls, sims, ovf_tot, halted_min = _calibrate_and_measure(
        program, n_seeds, target_wall_s, n_measure, seed_base, max_repeats, dev
    )
    # rate per dispatch = its own simulated seconds over its wall
    rates = np.asarray(sims) / np.asarray(walls)
    return {
        "n_seeds": n_seeds,
        "repeats": int(repeats),
        "calibration_wall_s": round(cal_wall, 4),
        "dispatch_walls_s": [round(w, 4) for w in walls],
        "sim_s_per_dispatch": [round(s, 3) for s in sims],
        "sim_s_per_s_median": round(float(np.median(rates)), 1),
        "sim_s_per_s_min": round(float(rates.min()), 1),
        "sim_s_per_s_max": round(float(rates.max()), 1),
        "spread_pct": round(
            100.0 * (rates.max() - rates.min()) / max(float(np.median(rates)), 1e-9),
            1,
        ),
        "overflow": ovf_tot,
        "all_halted": halted_min == repeats * n_seeds,
        "device_walls_s": None if dwalls is None else [round(w, 4) for w in dwalls],
    }


def measure_latency(
    wl: Workload,
    cfg: EngineConfig,
    max_steps: int,
    target_wall_s: float = 3.5,
    n_measure: int = 3,
    seed_base: int = 0,
    seed_mod: int = 131072,
    max_repeats: int = 131072,
    device=None,
) -> dict:
    """Wall microseconds per complete single-seed simulation: ``repeats``
    one-seed runs packed into each dispatch, the median wall per run.
    The same correctness contract as :func:`measure_throughput`."""
    dev = resolve_device(device)
    program = make_repeat_program(wl, cfg, max_steps, 1, seed_mod, min_size=1, device=dev)
    # cal_repeats=32: a single 1-seed run is far too short to time
    repeats, cal_wall, walls, dwalls, sims, ovf_tot, halted_min = _calibrate_and_measure(
        program, 1, target_wall_s, n_measure, seed_base, max_repeats, dev,
        cal_repeats=32,
    )
    lat_us = np.asarray(walls) / repeats * 1e6
    med = float(np.median(lat_us))
    return {
        "n_seeds": 1,
        "repeats": int(repeats),
        "calibration_wall_s": round(cal_wall, 4),
        "dispatch_walls_s": [round(w, 4) for w in walls],
        "wall_us_per_sim_median": round(med, 2),
        "spread_pct": round(
            100.0 * float(lat_us.max() - lat_us.min()) / max(med, 1e-9), 1
        ),
        "sim_s_per_s": round(float(np.sum(sims) / np.sum(walls)), 2),
        "overflow": ovf_tot,
        "all_halted": halted_min == repeats,
        "device_walls_s": None if dwalls is None else [round(w, 4) for w in dwalls],
    }


def null_dispatch_stats(n: int = 20, device=None) -> dict:
    """The per-dispatch overhead floor: a trivial op (``x + 1`` on one
    int32 element) timed the way every dispatch is."""
    dev = resolve_device(device)
    x = torch.zeros((), dtype=torch.int32, device=dev)
    _timed(lambda: x + 1, dev)
    walls, dwalls = [], []
    for _ in range(n):
        wall, dwall, _out = _timed(lambda: x + 1, dev)
        walls.append(wall)
        dwalls.append(dwall)
    w = np.asarray(walls)
    return {
        "n": n,
        "min_ms": round(float(w.min()) * 1e3, 3),
        "median_ms": round(float(np.median(w)) * 1e3, 3),
        "p90_ms": round(float(np.quantile(w, 0.9)) * 1e3, 3),
        "max_ms": round(float(w.max()) * 1e3, 3),
        "device_median_ms": (
            round(float(np.median(dwalls)) * 1e3, 4) if dev.type == "cuda" else None
        ),
    }
