"""Shared helper of the torch port's kernel tests: the run kernel's
step code (``csrc/engine_step.cuh`` and a model header) built for the
host with g++, and driven over CPU tensors through the same argument
packing as the CUDA launch. Imports no JAX, so the card-only tests that
use it run where JAX is absent."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused

HOST_UNIT = r"""
#include "{header}"
namespace {{
using Model = {cxx};
template <int E>
void run_all(const madsim::RunArgs& a, const Model::Params& p, int64_t n) {{
  for (int64_t i = 0; i < n; i++) madsim::run_seed<Model, E>(a, p, i);
}}
}}  // namespace
extern "C" int host_run(void* const* ptrs, const int64_t* cfg, int64_t n,
                        int32_t pool, int32_t stop_at_halt) {{
  const madsim::RunArgs a = madsim::run_args(ptrs, cfg, n, stop_at_halt);
  const Model::Params p = Model::params(cfg + madsim::kEngineWords);
  switch (pool) {{
{cases}
    default: return -1;
  }}
}}
"""


def build_host_kernel(tmp_dir, spec, pools):
    """g++ build of ``spec``'s device code (engine_step.cuh and its model
    header, MADSIM_HD = plain C++) with a host entry point that runs the
    kernel's per-seed loop over CPU tensors; a ctypes library."""
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    cases = "\n".join(
        f"    case {e}: run_all<{e}>(a, p, n); return 0;" for e in pools
    )
    src = tmp_dir / f"host_{spec.key}.cpp"
    src.write_text(HOST_UNIT.format(header=spec.header, cxx=spec.cxx, cases=cases))
    lib = tmp_dir / f"libhost_{spec.key}.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror", "-shared",
         "-fPIC", f"-I{fused.CSRC}", "-o", str(lib), str(src)],
        check=True, capture_output=True, text=True,
    )
    h = ctypes.CDLL(str(lib))
    h.host_run.restype = ctypes.c_int
    h.host_run.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
    ]
    return h


def host_launch(lib, wl, cfg, out, budget, stop_at_halt, words=None):
    """One launch of the host build on CPU state ``out`` (in place);
    returns each seed's step count. ``words`` defaults to the
    registered model's config words."""
    s, e = out.ev_valid.shape
    iters = torch.empty((s,), dtype=torch.int64)
    if words is None:
        words = fused.config_words(wl, cfg)
    ptrs, c = fused.kernel_args(out, fused._tables(wl, "cpu"), budget, iters, words)
    assert lib.host_run(ptrs, c, s, e, int(stop_at_halt)) == 0
    return iters


def host_run(lib, wl, cfg, st, n_steps, until_halted, words=None):
    """make_run_fused's two-pass protocol, with the host build."""
    out = tcore.SimState(**{f: getattr(st, f).clone() for f in tcore.STATE_FIELDS})
    s = st.seed.shape[0]
    budget = torch.full((s,), n_steps, dtype=torch.int64)
    iters = host_launch(lib, wl, cfg, out, budget, until_halted, words)
    if until_halted:
        host_launch(lib, wl, cfg, out, iters.max() - iters, False, words)
    return out


def assert_host_matches_plain(lib, wl, cfg, seeds, n_steps, until_halted):
    """The host build's run (with the workload's own config words) equals
    the plain step per field; returns the plain run as numpy."""
    from madsim_tpu_torch.engine.convert import state_to_numpy

    st = tcore.make_init(wl, cfg, device="cpu")(seeds)
    run = tcore.make_run_while_plain if until_halted else tcore.make_run_plain
    want = state_to_numpy(run(wl, cfg, n_steps)(st))
    got = state_to_numpy(host_run(lib, wl, cfg, st, n_steps, until_halted))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    return want
