"""Shared helper of the torch port's kernel tests: the run kernel's
step code (``csrc/engine_step.cuh``, ``csrc/lanes.cuh`` and a model
header) built for the host with g++, and driven over CPU tensors
through the same argument packing as the CUDA launch. On the host one
thread plays each seed's G lanes in turn (``csrc/lanes.cuh``). Imports
no JAX, so the card-only tests that use it run where JAX is absent."""

import _torch_threads  # noqa: F401
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused

HOST_UNIT = r"""
#include <memory>
#include "{header}"
{draws}
{threads}namespace {{
using Model = {cxx};
constexpr int G = {group};
#ifndef MADSIM_THREADS
#define MADSIM_THREADS G
#endif
// seeds a block, as the card's kernels take them (one by default)
constexpr int kSeeds = MADSIM_THREADS / G;
int nb_of(int64_t n, int64_t first) {{
  return n - first < kSeeds ? static_cast<int>(n - first) : kSeeds;
}}
template <int E, bool MET, bool OBS>
void run_all(const madsim::RunArgs& a, const Model::Params& p) {{
  // a block's seeds' Seed and, with OBS, their observability tails
  const size_t bytes =
      madsim::seed_stride<madsim::Seed<Model, E, MET>, Model::N, E>(a.cfg) * kSeeds;
  std::unique_ptr<madsim::Vec16[]> mem(new madsim::Vec16[(bytes + 15) / 16]());
  const auto blk = madsim::make_block<Model, E, MET, OBS>(
      reinterpret_cast<unsigned char*>(mem.get()), a.cfg);
  int64_t most = 0;
  for (int64_t i = 0; i < a.n_seeds; i += kSeeds) {{
    const int64_t m = madsim::run_block<Model, E, G, MET, OBS>(blk, a, p, i,
                                                               nb_of(a.n_seeds, i), 0, 1);
    most = m > most ? m : most;
  }}
  if (a.tmax != nullptr) *a.tmax = most;
}}
template <int E>
void drain_all(const madsim::DrainArgs& d) {{
  auto blk = std::make_unique<madsim::DrainSeed<E>[]>(kSeeds);
  for (int64_t i = 0; i < d.n_seeds; i += kSeeds)
    madsim::drain_block<E, G>(blk.get(), d, i, nb_of(d.n_seeds, i), 0, 1);
}}
}}  // namespace
extern "C" int host_run(void* const* ptrs, const int64_t* cfg, int64_t n,
                        int64_t budget, int32_t pool, int32_t stop_at_halt,
                        int32_t metrics, int32_t obs) {{
  const madsim::RunArgs a = madsim::run_args(ptrs, cfg, n, budget, stop_at_halt);
  const Model::Params p = Model::params(cfg + madsim::kEngineWords);
  switch (pool) {{
{run_cases}
    default: return -1;
  }}
}}
extern "C" int64_t host_seed_bytes(int32_t pool, int32_t metrics) {{
  switch (pool) {{
{bytes_cases}
    default: return -1;
  }}
}}
extern "C" int host_drain(void* const* ptrs, int64_t n, int32_t pool) {{
  const madsim::DrainArgs d = madsim::drain_args(ptrs, n);
  switch (pool) {{
{drain_cases}
    default: return -1;
  }}
}}
"""


def build_host_kernel(tmp_dir, spec, pools, group=None, obs=False, threads=None):
    """g++ build of ``spec``'s device code (engine_step.cuh, lanes.cuh
    and its model header, MADSIM_HD = plain C++) with host entry points
    that run the kernel's blocks over CPU tensors, with ``group`` lanes
    per seed (the model's own by default) and, with ``obs``, the
    instantiation with the coverage taps and the timeline ring; a ctypes
    library. A block holds one seed, or with ``threads`` (the unit's
    MADSIM_THREADS) ``threads / group`` seeds, side by side in one
    buffer as in the card's shared memory. ``host_seed_bytes(pool,
    metrics)`` is the size of one seed's ``Seed`` at each pool."""
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    group = spec.group if group is None else group

    def case(e, o):
        return f"metrics ? run_all<{e}, true, {o}>(a, p) : run_all<{e}, false, {o}>(a, p)"

    run_cases = "\n".join(
        f"    case {e}: if (obs) {{ {case(e, 'true') if obs else 'return -2'}; }} "
        f"else {{ {case(e, 'false')}; }} return 0;" for e in pools
    )
    drain_cases = "\n".join(f"    case {e}: drain_all<{e}>(d); return 0;" for e in pools)
    bytes_cases = "\n".join(
        f"    case {e}: return static_cast<int64_t>(metrics ? sizeof(madsim::Seed<Model, {e}, "
        f"true>) : sizeof(madsim::Seed<Model, {e}, false>));" for e in pools)
    src = tmp_dir / f"host_{spec.key}_g{group}.cpp"
    src.write_text(HOST_UNIT.format(header=spec.header, draws=spec.traits_source(),
                                    cxx=spec.cxx, group=group,
                                    threads=f"#define MADSIM_THREADS {threads}\n" if threads else "",
                                    run_cases=run_cases, drain_cases=drain_cases,
                                    bytes_cases=bytes_cases))
    lib = tmp_dir / f"libhost_{spec.key}_g{group}.so"
    subprocess.run(
        ["g++", "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror", "-shared",
         "-fPIC", f"-I{fused.CSRC}", "-o", str(lib), str(src)],
        check=True, capture_output=True, text=True,
    )
    h = ctypes.CDLL(str(lib))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    h.host_run.restype = ctypes.c_int
    h.host_run.argtypes = [ctypes.POINTER(ptr), ctypes.POINTER(i64), i64, i64, i32, i32, i32,
                           i32]
    h.host_drain.restype = ctypes.c_int
    h.host_drain.argtypes = [ctypes.POINTER(ptr), i64, i32]
    h.host_seed_bytes.restype = i64
    h.host_seed_bytes.argtypes = [i32, i32]
    return h


def host_launch(lib, wl, cfg, state, budget, stop_at_halt, words=None, latency=None,
                retry=None):
    """One run launch of the host build from CPU state ``state`` into
    fresh outputs; returns ``(out, iters, tmax)``. ``words`` defaults
    to the registered model's config words; a state with the counter
    row runs the instantiation with the fleet counters, one with a
    coverage or ring column the one with the taps, one with latency
    columns folds the markers under ``latency`` and one with retry
    columns runs the timers of ``retry``."""
    s, e = state.ev_valid.shape
    markers = wl.lat_markers > 0
    out = fused.fresh_outputs(state, markers)
    iters = torch.empty((s,), dtype=torch.int64)
    tmax = torch.empty((1,), dtype=torch.int64)
    if words is None:
        words = fused.config_words(wl, cfg)
    ptrs, c = fused.kernel_args(state, out, fused._tables(wl, "cpu"), iters, tmax, words,
                                latency, markers, retry)
    assert lib.host_run(ptrs, c, s, int(budget), e, int(stop_at_halt),
                        int(fused.has_metrics(state)), int(fused.has_obs(state))) == 0
    return out, iters, tmax


def host_drain(lib, out, iters, tmax):
    """The drain kernel's host build, in place on ``out``."""
    tensors = [getattr(out, f) for f in fused.DRAIN_FIELDS] + [iters, tmax]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    assert lib.host_drain(ptrs, out.seed.shape[0], out.ev_valid.shape[1]) == 0


def host_run(lib, wl, cfg, st, n_steps, until_halted, words=None, latency=None, retry=None):
    """make_run_fused's protocol (a run launch, then for make_run_while
    the drain launch), with the host build."""
    out, iters, tmax = host_launch(lib, wl, cfg, st, n_steps, until_halted, words, latency,
                                   retry)
    if until_halted:
        host_drain(lib, out, iters, tmax)
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
