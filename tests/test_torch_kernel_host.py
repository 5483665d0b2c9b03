"""The run kernel's step code, built for the host, against the plain step.

``csrc/step_raft.cuh`` marks its functions MADSIM_HD, which is
``__host__ __device__`` under nvcc and nothing under g++. Here g++
builds it (no torch headers) with a small host driver into a ctypes
library in a temporary directory, and the library runs the kernel's
exact per-seed loop — load, step or drain, store — over the port's
CPU tensors through the same argument packing the CUDA launch uses.
This is the CPU evidence of the kernel's logic; the package never uses
the host build. The last test runs the real kernel and needs a card.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.models import BENCH_SPECS, make_raft

DRIVER = r"""
#include "step_raft.cuh"
extern "C" int host_raft_run(void* const* ptrs, const int64_t* cfg, int64_t n,
                             int32_t pool, int32_t stop_at_halt) {
  const madsim::RaftArgs a = madsim::raft_args(ptrs, cfg, n, stop_at_halt);
  for (int64_t i = 0; i < n; i++) {
    switch (pool) {
      case 40: madsim::raft_run_seed<40>(a, i); break;
      case 64: madsim::raft_run_seed<64>(a, i); break;
      case 128: madsim::raft_run_seed<128>(a, i); break;
      case 256: madsim::raft_run_seed<256>(a, i); break;
      default: return -1;
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    d = tmp_path_factory.mktemp("raft_host")
    (d / "driver.cpp").write_text(DRIVER)
    lib = d / "libraft_host.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror", "-shared",
         "-fPIC", f"-I{fused.CSRC}", "-o", str(lib), str(d / "driver.cpp")],
        check=True, capture_output=True, text=True,
    )
    h = ctypes.CDLL(str(lib))
    h.host_raft_run.restype = ctypes.c_int
    h.host_raft_run.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
    ]
    return h


def host_run(lib, wl, cfg, st, n_steps, until_halted):
    """make_run_fused's two-pass protocol, with the host build."""
    out = tcore.SimState(**{f: getattr(st, f).clone() for f in tcore.STATE_FIELDS})
    tables = fused._tables(wl, "cpu")
    words = fused.raft_config_words(wl, cfg)
    s, e = st.ev_valid.shape

    def launch(budget, stop):
        iters = torch.empty((s,), dtype=torch.int64)
        ptrs, c = fused.kernel_args(out, tables, budget, iters, words)
        assert lib.host_raft_run(ptrs, c, s, e, int(stop)) == 0
        return iters

    iters = launch(torch.full((s,), n_steps, dtype=torch.int64), until_halted)
    if until_halted:
        launch(iters.max() - iters, False)
    return out


@pytest.mark.parametrize(
    "kw,n_steps,until_halted",
    [
        (dict(pool_size=128, loss_p=0.02), 1, False),
        (dict(pool_size=128, loss_p=0.02), 60, False),
        (BENCH_SPECS["raft"][1], BENCH_SPECS["raft"][3], True),
        (dict(pool_size=64, loss_p=0.02, time_limit_ns=200_000_000), 100, False),
        (dict(pool_size=40, loss_p=1.0), 50, False),
        (dict(pool_size=256, loss_p=0.3), 150, True),
    ],
    ids=["entry_1", "entry_60", "bench_while", "time_limit", "certain_loss", "lossy_256"],
)
def test_host_built_kernel_matches_plain_step(host_lib, kw, n_steps, until_halted):
    wl, cfg = make_raft(), tcore.EngineConfig(**kw)
    st = tcore.make_init(wl, cfg, device="cpu")(np.arange(64, dtype=np.uint64) * np.uint64(7919))
    run = tcore.make_run_while_plain if until_halted else tcore.make_run_plain
    want = state_to_numpy(run(wl, cfg, n_steps)(st))
    got = state_to_numpy(host_run(host_lib, wl, cfg, st, n_steps, until_halted))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_host_built_kernel_halt_counts(host_lib):
    """The stop-at-halt pass reports, per seed, the steps a plain loop
    needs until that seed halts."""
    factory, kw, _n, cap = BENCH_SPECS["raft"]
    wl, cfg = factory(), tcore.EngineConfig(**kw)
    st = tcore.make_init(wl, cfg, device="cpu")(np.arange(16, dtype=np.uint64))
    out = tcore.SimState(**{f: getattr(st, f).clone() for f in tcore.STATE_FIELDS})
    iters = torch.empty((16,), dtype=torch.int64)
    ptrs, c = fused.kernel_args(
        out, fused._tables(wl, "cpu"), torch.full((16,), cap, dtype=torch.int64),
        iters, fused.raft_config_words(wl, cfg),
    )
    assert host_lib.host_raft_run(ptrs, c, 16, 40, 1) == 0
    step = tcore.make_step_plain(wl, cfg)
    halted_at = np.full(16, -1)
    for i in range(int(iters.max())):
        st = step(st)
        newly = st.halted.numpy() & (halted_at < 0)
        halted_at[newly] = i + 1
    np.testing.assert_array_equal(iters.numpy(), halted_at)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_step_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card with -m cuda)")
    factory, kw, _n, cap = BENCH_SPECS["raft"]
    wl, cfg = factory(), tcore.EngineConfig(**kw)
    st = tcore.make_init(wl, cfg, device="cuda")(np.arange(4096, dtype=np.uint64))
    before = fused.KERNEL.launches
    got = tcore.make_run_while(wl, cfg, cap)(st)
    assert fused.KERNEL.launches == before + 2
    want = tcore.make_run_while_plain(wl, cfg, cap)(st)
    a, b = state_to_numpy(got), state_to_numpy(want)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    with pytest.raises(NotImplementedError):
        bad = tcore.Workload(name="other", n_nodes=5, state_width=6,
                             handlers=wl.handlers, max_emits=6, args_words=2)
        tcore.make_run(bad, cfg, 3)(st)
