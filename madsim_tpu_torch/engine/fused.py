"""The fused run kernel: the whole step loop in one CUDA launch.

Port of ``madsim_tpu/engine/vmem.py:make_run_vmem``, the JAX package's
one Pallas kernel, which runs ``n_steps`` of ``vmap(make_step)`` with
each block of seeds' state resident on chip. On the H100 the kernel is
hand-written CUDA C++ for ``sm_90a`` (``csrc/run_kernel.cu``): one
thread per seed, each seed's pool, node rows and clog matrix in
thread-local arrays for the whole loop, the raft handlers as device
code (``csrc/step_raft.cuh``). It carries the raft election workload;
any other workload on a CUDA state raises ``NotImplementedError``.

The kernel is built with nvcc on first use into ``build/kernels/<hash>/``
at the root of the checkout (keyed by a hash of the sources and flags)
and loaded with ctypes. A CPU state runs the plain eager step instead
(``core.make_run_plain``); a CUDA state never does.

``make_run_while`` semantics: the JAX loop runs every seed for the same
``T = min(cap, steps until every seed has halted)`` iterations, and a
halted seed's iteration still consumes its earliest slot and counts a
step. The wrapper launches the kernel twice: first every seed runs
until it halts (or the cap) and reports its count; then, with
``T = max`` of the counts taken on the device, each seed takes its
remaining ``T - count`` halted steps.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .core import (
    STATE_FIELDS,
    EngineConfig,
    SimState,
    Workload,
    make_run_plain,
    make_run_while_plain,
)

__all__ = [
    "KERNEL",
    "POOL_SIZES",
    "NVCC_FLAGS",
    "RunKernel",
    "build_library",
    "halt_counts",
    "kernel_args",
    "make_run_fused",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("threefry.cuh", "step_raft.cuh", "run_kernel.cu")
BUILD_ROOT = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--resource-usage",
)
POOL_SIZES = (40, 64, 128, 256)

# the fields the kernel reads (and, but for seed and slow, writes), in
# the pointer order of RaftArgs (csrc/step_raft.cuh)
KERNEL_FIELDS = (
    "seed", "now", "step", "halted", "halt_time", "trace", "overflow",
    "msg_count", "ev_time", "ev_valid", "ev_meta", "ev_epoch", "ev_args",
    "alive", "paused", "epoch", "node_state", "clog", "slow",
)
_DTYPES = {
    "seed": torch.int64, "now": torch.int64, "step": torch.int64,
    "halted": torch.bool, "halt_time": torch.int64, "trace": torch.int64,
    "overflow": torch.int32, "msg_count": torch.int64,
    "ev_time": torch.int64, "ev_valid": torch.bool, "ev_meta": torch.int64,
    "ev_epoch": torch.int32, "ev_args": torch.int32, "ev_pay": torch.int32,
    "alive": torch.bool, "paused": torch.bool, "epoch": torch.int32,
    "node_state": torch.int32, "clog": torch.bool, "slow": torch.int32,
    "dup": torch.bool, "skew": torch.int32,
}
RAFT_NAME = "raft-election"
RAFT_SHAPE = dict(n_nodes=5, state_width=6, args_words=2, payload_words=0,
                  max_emits=6)


def source_digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the run kernel is built with the CUDA toolkit")


def build_library() -> tuple[Path, str]:
    """Build the kernel library if this source hash has none yet.

    Returns ``(path, log)``; ``log`` is nvcc's output, with the
    ``--resource-usage`` lines (registers, local memory per thread)."""
    out_dir = BUILD_ROOT / source_digest()
    lib = out_dir / "libmadsim_run.so"
    log_path = out_dir / "build.log"
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libmadsim_run.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "run_kernel.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (
        f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        f"# {time.perf_counter() - t0:.1f} s\n"
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building the run kernel:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return lib, log


class RunKernel:
    """The loaded kernel library and its launch count.

    ``launches`` counts kernel launches only: a CPU state that takes
    the plain step counts nothing."""

    def __init__(self):
        self.launches = 0
        self._lib = None

    def load(self):
        if self._lib is None:
            path, _log = build_library()
            lib = ctypes.CDLL(str(path))
            lib.madsim_raft_run.restype = ctypes.c_int
            lib.madsim_raft_run.argtypes = [
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_void_p,
            ]
            self._lib = lib
        return self._lib

    def launch(self, state: SimState, tables, budget, iters, cfg_words,
               stop_at_halt: bool) -> None:
        lib = self.load()
        ptrs, cfg = kernel_args(state, tables, budget, iters, cfg_words)
        rc = lib.madsim_raft_run(
            ptrs, cfg, state.seed.shape[0], state.ev_valid.shape[1],
            int(stop_at_halt), state.device.index or 0,
            torch.cuda.current_stream(state.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"run kernel launch failed: error {rc}")
        self.launches += 1


KERNEL = RunKernel()


def raft_config_words(wl: Workload, cfg: EngineConfig) -> tuple:
    """The 10 config words of ``raft_args`` (csrc/step_raft.cuh)."""
    p = dict(wl.model_params)
    return (
        cfg.lat_min_ns, cfg.lat_max_ns, cfg.loss_u32, cfg.proc_min_ns,
        cfg.proc_max_ns, cfg.clog_backoff_min_ns, cfg.clog_backoff_max_ns,
        cfg.time_limit_ns, p["timeout_min_ns"], p["timeout_max_ns"],
    )


def kernel_args(state: SimState, tables, budget, iters, cfg_words):
    """The ctypes pointer array and config words of one launch. The
    caller keeps every tensor alive until the launch has run."""
    tensors = [getattr(state, f) for f in KERNEL_FIELDS]
    tensors += [tables[0], tables[1], budget, iters]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    cfg = (ctypes.c_int64 * len(cfg_words))(*cfg_words)
    return ptrs, cfg


def check_raft(wl: Workload) -> None:
    """Raise unless the kernel carries this workload."""
    if wl.name != RAFT_NAME:
        raise NotImplementedError(
            f"the fused run kernel carries only {RAFT_NAME!r}; workload "
            f"{wl.name!r} has no device handlers yet (ROADMAP queue B1)"
        )
    p = dict(wl.model_params)
    shape = {k: getattr(wl, k) for k in RAFT_SHAPE}
    shape["n_nodes"] = p.get("n_nodes")
    if shape != RAFT_SHAPE or tuple(wl.draw_purposes or ()) != (0,):
        raise NotImplementedError(
            f"the fused run kernel is compiled for raft at {RAFT_SHAPE}; "
            f"got {shape}"
        )


def check_state(wl: Workload, state: SimState) -> None:
    """Raise unless every field is a contiguous CUDA tensor of the
    port's dtype and of the workload's shape, with a pool size the
    kernel was compiled for."""
    dev = state.device
    s, e = state.ev_valid.shape
    if e not in POOL_SIZES:
        raise ValueError(
            f"pool_size={e} has no kernel instantiation; supported: "
            f"{POOL_SIZES}"
        )
    n, u = wl.n_nodes, wl.state_width
    shapes = dict(
        ev_time=(s, e), ev_valid=(s, e), ev_meta=(s, e), ev_epoch=(s, e),
        ev_args=(s, e, wl.args_words), ev_pay=(s, e, wl.payload_words),
        alive=(s, n), paused=(s, n), epoch=(s, n), skew=(s, n),
        node_state=(s, n, u), clog=(s, n, n), slow=(s, n, n),
    )
    for name in STATE_FIELDS:
        t = getattr(state, name)
        if t.device != dev or t.dtype != _DTYPES[name] or not t.is_contiguous():
            raise ValueError(
                f"field {name!r}: {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ', not contiguous'}; the "
                f"kernel takes contiguous {_DTYPES[name]} on {dev}"
            )
        want = shapes.get(name, (s,))
        if tuple(t.shape) != want:
            raise ValueError(
                f"field {name!r} has shape {tuple(t.shape)}, the workload's "
                f"is {want}"
            )
    if dev.type != "cuda":
        raise ValueError(f"the run kernel needs a CUDA state, got {dev}")


def _tables(wl: Workload, dev) -> tuple:
    """The restart tables as kernel inputs: (N,U) int32, (U,) uint8."""
    return (
        torch.from_numpy(wl.initial_state()).to(dev),
        torch.from_numpy(wl.volatile_mask().astype("uint8")).to(dev),
    )


def _first_pass(wl: Workload, cfg: EngineConfig, state: SimState,
                n_steps: int, stop_at_halt: bool):
    """Copy ``state`` and launch the kernel once on the copy, up to
    ``n_steps`` steps per seed. Returns the copy, the launch's inputs
    and each seed's step count."""
    check_raft(wl)
    check_state(wl, state)
    dev = state.device
    out = SimState(**{f: getattr(state, f).clone() for f in STATE_FIELDS})
    tables = _tables(wl, dev)
    words = raft_config_words(wl, cfg)
    s = state.seed.shape[0]
    budget = torch.full((s,), n_steps, dtype=torch.int64, device=dev)
    iters = torch.empty((s,), dtype=torch.int64, device=dev)
    KERNEL.launch(out, tables, budget, iters, words, stop_at_halt)
    return out, tables, words, iters


def make_run_fused(
    wl: Workload, cfg: EngineConfig, n_steps: int, until_halted: bool = False
):
    """Build ``run(state) -> SimState``: ``n_steps`` steps (or, with
    ``until_halted``, steps until every seed has halted, at most
    ``n_steps``) in the fused kernel. A CPU state takes the plain
    step; a CUDA state launches the kernel or raises."""
    plain = (
        make_run_while_plain(wl, cfg, n_steps) if until_halted
        else make_run_plain(wl, cfg, n_steps)
    )

    def run(state: SimState) -> SimState:
        if state.device.type == "cpu":
            return plain(state)
        out, tables, words, iters = _first_pass(
            wl, cfg, state, n_steps, until_halted
        )
        if until_halted and iters.numel():
            # the halted seeds' remaining iterations, T = max count
            KERNEL.launch(out, tables, iters.max() - iters,
                          torch.empty_like(iters), words, False)
        return out

    return run


def halt_counts(wl: Workload, cfg: EngineConfig, cap: int, state: SimState):
    """Each seed's steps until it halts (at most ``cap``), from one
    stop-at-halt kernel pass on a copy of ``state``: the seed-steps a
    ``make_run_while`` run does real work in."""
    return _first_pass(wl, cfg, state, cap, True)[3]
