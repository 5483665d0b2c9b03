// The fused run kernel on Hopper (sm_90a), for one workload, and its
// drain kernel.
//
// Replaces madsim_tpu/engine/vmem.py:make_run_vmem, the JAX package's
// one Pallas kernel, which keeps each block of seeds' SimState in VMEM
// for all n_steps of vmap(make_step). Here a block of kThreads threads
// (MADSIM_THREADS, 128 unless the unit sets fewer) runs kSeeds =
// kThreads / G seeds: it loads their state into shared
// memory once, with all its threads and coalesced (engine_step.cuh
// block_load), runs each seed on a group of G lanes until it halts or
// its budget is spent, and stores the state once, into fresh output
// tensors. The input is never written, so the wrapper copies nothing.
//
// make_run_while's second launch is the drain kernel: a halted seed's
// remaining T - count steps only clear its earliest valid slots and
// count steps, so it reads step, ev_valid and ev_time where valid, ranks
// the slots once (lanes.cuh drain_slots) and writes only the slots it
// clears and step. T, the largest count, is an atomicMax into a device
// word that the run kernel leaves behind: nothing runs between the two
// launches.
//
// A record variant (a model trait with R > 0 history rows a call) also
// carries the operation history: hist_count and hist_drop live in the
// seed's shared state, the block copies the input's history rows to the
// output once, and each record a user dispatch appends is written
// straight to the output (engine_step.cuh append_history). The drain
// kernel never touches the history.
//
// A model with the sync discipline (SYNC) carries its nodes' storage
// state in the seed's shared state and writes it back. The fleet
// metrics are a compile-time switch: each library holds two
// instantiations of the run kernel, without and with the seed's MET_*
// counters, and madsim_run picks one by its `metrics` word (the width of
// the state's met column). The drain kernel touches neither.
//
// The coverage taps and the timeline ring are a third compile-time
// switch, instantiated only at the pools a library lists in
// MADSIM_OBS_POOLS (engine/fused.py KernelModel.obs_pools), so every
// other kernel is built as before; madsim_run picks it by its `obs` word
// (a state with a coverage or ring column). Their widths are runtime
// config words 9-11 (engine_step.cuh): each seed's observability state
// follows its Seed in the block's shared memory, so that kernel's
// dynamic shared size is kSeeds * seed_stride, set per launch. The
// ring's rows are written straight to the output, after the block
// copies the input's rows there.
//
// The tail-latency tap needs no switch: it compiles in only for a model
// with latency markers (its trait's L, engine_step.cuh LatOf), and its
// widths are runtime config words 12-14. Its columns stay in device
// memory: the block copies the input's rows to the output and the
// leader folds each marker there. The client-retry timers compile into
// the same kernels, and only those: a runtime word (config word 16, the
// policy's op count) switches them on, the policy's fields and backoff
// tables follow it in RunArgs::rt, and the three per-op books stay in
// device memory as the latency columns do.
//
// This file is not compiled alone. engine/fused.py writes, per model, a
// unit that includes the model's header (model_*.cuh), defines
//   MADSIM_MODEL  the model trait, e.g. madsim::KvChaosModel<false, true>
//   MADSIM_POOLS  the pool sizes to instantiate, e.g. 40, 64
//   MADSIM_GROUP  G, the lanes per seed
//   MADSIM_OBS_POOLS  the pools with the observability kernel (may be
//                     empty)
// and, for a library whose seeds are too large for 128 / G of them in a
// block's shared memory, MADSIM_THREADS, the threads a block (whole
// groups; engine/fused.py picks it from the seed's bytes), and includes
// this file; nvcc builds it into one library per model.
//
// What bounds it: device memory sees one load and one store of the
// state per run; per step a seed does a pool scan and a few threefry
// blocks (chip_smoke.py computes both terms for bound_ms). The step is
// serial per seed and its latency is what costs: shared memory keeps
// the pool one load away instead of in local memory, G lanes cut the
// scan and the emit work by G, and kSeeds seeds per block with several
// blocks per SM keep enough groups in flight to hide it
// (madsim_occupancy reports how many).
//
// Built by engine/fused.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//        --Werror cross-execution-space-call
// and loaded with ctypes: the C entry points below take the field
// pointers, the card's index and the stream, and return the launch's
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "engine_step.cuh"

#if !defined(MADSIM_MODEL) || !defined(MADSIM_POOLS) || !defined(MADSIM_GROUP) || \
    !defined(MADSIM_OBS_POOLS)
#error "define MADSIM_MODEL, MADSIM_POOLS, MADSIM_GROUP and MADSIM_OBS_POOLS, then include run_kernel.cu"
#endif
#ifndef MADSIM_THREADS
#define MADSIM_THREADS 128
#endif

namespace {

using Model = MADSIM_MODEL;
constexpr int kGroup = MADSIM_GROUP;
constexpr int kThreads = MADSIM_THREADS;
constexpr int kSeeds = kThreads / kGroup;
// whole groups, and whole warps unless one warp's groups do not fit
static_assert(kThreads >= kGroup && kThreads <= 128 && kThreads % kGroup == 0 &&
                  (kThreads % 32 == 0 || kThreads < 32),
              "whole warps, whole groups");

template <int E, bool MET>
constexpr size_t run_smem() { return sizeof(madsim::Seed<Model, E, MET>) * kSeeds; }
// the run kernel's shared bytes, with OBS under the run's taps
template <int E, bool MET, bool OBS>
size_t run_smem(const madsim::EngineConfig& c) {
  if constexpr (OBS) {
    return madsim::seed_stride<madsim::Seed<Model, E, MET>, Model::N, E>(c) * kSeeds;
  } else {
    return run_smem<E, MET>();
  }
}
template <int E>
constexpr size_t drain_smem() { return sizeof(madsim::DrainSeed<E>) * kSeeds; }

template <int E, bool MET, bool OBS>
__global__ void __launch_bounds__(kThreads)
run_kernel(const madsim::RunArgs a, const typename Model::Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long block_max;
  const auto blk = madsim::make_block<Model, E, MET, OBS>(smem, a.cfg);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kSeeds;
  const int64_t left = a.n_seeds - first;
  const int nb = left < kSeeds ? static_cast<int>(left) : kSeeds;
  if (threadIdx.x == 0) block_max = 0;
  const int64_t most = madsim::run_block<Model, E, kGroup, MET, OBS>(
      blk, a, p, first, nb, threadIdx.x, blockDim.x);
  if (a.tmax != nullptr) {
    if (most > 0) atomicMax(&block_max, static_cast<unsigned long long>(most));
    __syncthreads();
    if (threadIdx.x == 0 && block_max > 0)
      atomicMax(reinterpret_cast<unsigned long long*>(a.tmax), block_max);
  }
}

template <int E>
__global__ void __launch_bounds__(kThreads) drain_kernel(const madsim::DrainArgs d) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto* blk = reinterpret_cast<madsim::DrainSeed<E>*>(smem);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kSeeds;
  const int64_t left = d.n_seeds - first;
  const int nb = left < kSeeds ? static_cast<int>(left) : kSeeds;
  madsim::drain_block<E, kGroup>(blk, d, first, nb, threadIdx.x, blockDim.x);
}

// a block above 48 KB of shared memory needs the attribute; the kernels'
// static words (run_kernel's block_max) count against the 48 KB too, so
// the attribute is set from 1 KB below it
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes + 1024 <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

unsigned blocks_for(int64_t n_seeds) {
  return static_cast<unsigned>((n_seeds + kSeeds - 1) / kSeeds);
}

template <int E, bool MET, bool OBS>
int launch_run(const madsim::RunArgs& a, const typename Model::Params& p,
               cudaStream_t stream) {
  const size_t smem = run_smem<E, MET, OBS>(a.cfg);
  cudaError_t rc = allow_smem(run_kernel<E, MET, OBS>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (a.tmax != nullptr) {
    rc = cudaMemsetAsync(a.tmax, 0, sizeof(int64_t), stream);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  run_kernel<E, MET, OBS><<<blocks_for(a.n_seeds), kThreads, smem, stream>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}

template <int E>
int launch_drain(const madsim::DrainArgs& d, cudaStream_t stream) {
  const cudaError_t rc = allow_smem(drain_kernel<E>, drain_smem<E>());
  if (rc != cudaSuccess) return static_cast<int>(rc);
  drain_kernel<E><<<blocks_for(d.n_seeds), kThreads, drain_smem<E>(), stream>>>(d);
  return static_cast<int>(cudaGetLastError());
}

// G, seeds per block, then for each kernel its dynamic shared bytes per
// block and its resident blocks per SM: the run kernel, the drain
// kernel, the run kernel with metrics
template <int E>
int occupancy(int64_t* out) {
  int run = 0, drain = 0, run_met = 0;
  cudaError_t rc = allow_smem(run_kernel<E, false, false>, run_smem<E, false>());
  if (rc == cudaSuccess) rc = allow_smem(drain_kernel<E>, drain_smem<E>());
  if (rc == cudaSuccess) rc = allow_smem(run_kernel<E, true, false>, run_smem<E, true>());
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&run, run_kernel<E, false, false>,
                                                       kThreads, run_smem<E, false>());
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&drain, drain_kernel<E>, kThreads,
                                                       drain_smem<E>());
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&run_met, run_kernel<E, true, false>,
                                                       kThreads, run_smem<E, true>());
  out[0] = kGroup;
  out[1] = kSeeds;
  out[2] = static_cast<int64_t>(run_smem<E, false>());
  out[3] = run;
  out[4] = static_cast<int64_t>(drain_smem<E>());
  out[5] = drain;
  out[6] = static_cast<int64_t>(run_smem<E, true>());
  out[7] = run_met;
  return static_cast<int>(rc);
}

// f(std::integral_constant<int, E>) for the instantiated pool E ==
// pool; -1 when there is none
template <int... Es, class F>
int with_pool(int32_t pool, F f) {
  int rc = -1;
  (void)((pool == Es && ((rc = f(std::integral_constant<int, Es>{})), true)) || ...);
  return rc;
}

template <int... Es>
constexpr int64_t count_pools() {
  return static_cast<int64_t>(sizeof...(Es));
}

}  // namespace

extern "C" {

// ptrs: the RunArgs pointers (madsim::run_args); cfg: the engine's
// config words, then the model's (Model::params); metrics: 1 runs the
// instantiation that folds the MET_* counters; obs: 1 the one with the
// observability taps. Returns a cudaError_t, or -1 for a pool size
// without an instantiation (the shared layout needs E at compile time;
// engine/fused.py lists the pools of each model, and its obs pools).
int madsim_run(void* const* ptrs, const int64_t* cfg, int64_t n_seeds, int64_t budget,
               int32_t pool, int32_t stop_at_halt, int32_t metrics, int32_t obs,
               int32_t device, void* stream) {
  const madsim::RunArgs a = madsim::run_args(ptrs, cfg, n_seeds, budget, stop_at_halt);
  const typename Model::Params p = Model::params(cfg + madsim::kEngineWords);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_seeds <= 0) return 0;
  // the stream belongs to the tensors' card
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (obs) {
    return with_pool<MADSIM_OBS_POOLS>(pool, [&](auto e) {
      return metrics ? launch_run<decltype(e)::value, true, true>(a, p, s)
                     : launch_run<decltype(e)::value, false, true>(a, p, s);
    });
  }
  return with_pool<MADSIM_POOLS>(pool, [&](auto e) {
    return metrics ? launch_run<decltype(e)::value, true, false>(a, p, s)
                   : launch_run<decltype(e)::value, false, false>(a, p, s);
  });
}

// ptrs: step, ev_valid, ev_time, iters, tmax (madsim::drain_args)
int madsim_drain(void* const* ptrs, int64_t n_seeds, int32_t pool, int32_t device,
                 void* stream) {
  const madsim::DrainArgs d = madsim::drain_args(ptrs, n_seeds);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_seeds <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return with_pool<MADSIM_POOLS>(pool, [&](auto e) { return launch_drain<decltype(e)::value>(d, s); });
}

// out: G, seeds per block, run kernel shared bytes per block and blocks
// per SM, drain kernel shared bytes and blocks per SM, and the metrics
// run kernel's shared bytes and blocks per SM, for `pool`
int madsim_occupancy(int32_t pool, int32_t device, int64_t* out) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return with_pool<MADSIM_POOLS>(pool, [&](auto e) { return occupancy<decltype(e)::value>(out); });
}

// the model's compile-time shape, for the wrapper to check against the
// workload: N, U, A, W, K, H, R, the run and drain pointer counts, the
// duplication shadow rows (0, or K for a dup_rows library), whether
// it keeps the sync discipline, how many pools have the observability
// kernel and its latency-marker rows a call
void madsim_shape(int64_t* out) {
  out[0] = Model::N;
  out[1] = Model::U;
  out[2] = Model::A;
  out[3] = Model::W;
  out[4] = Model::K;
  out[5] = Model::H;
  out[6] = Model::R;
  out[7] = madsim::kRunPointers;
  out[8] = madsim::kDrainPointers;
  out[9] = madsim::DupRows<Model>::n;
  out[10] = madsim::SyncOf<Model>::value;
  out[11] = count_pools<MADSIM_OBS_POOLS>();
  out[12] = madsim::LatOf<Model>::n;
}

}  // extern "C"
