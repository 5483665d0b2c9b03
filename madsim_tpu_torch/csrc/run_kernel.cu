// The fused run kernel on Hopper (sm_90a), for one workload.
//
// Replaces madsim_tpu/engine/vmem.py:make_run_vmem, the JAX package's
// one Pallas kernel, which keeps each block of seeds' SimState in VMEM
// for all n_steps of vmap(make_step). Here one CUDA thread runs one
// seed: it loads the seed's row once, keeps its event pool, node rows
// and clog matrix in thread-local arrays for the whole loop
// (engine_step.cuh), and stores the row once.
//
// This file is not compiled alone. engine/fused.py writes, per model, a
// unit that includes the model's header (model_*.cuh), defines
//   MADSIM_MODEL  the model trait, e.g. madsim::KvChaosModel<true>
//   MADSIM_POOLS  the pool sizes to instantiate, e.g. 40, 64
// and includes this file; nvcc builds it into one library per model.
//
// What bounds it: device memory sees one load and one store of the
// state per launch; per step a seed does a few threefry blocks (20
// rounds of 32-bit add/rotate/xor each) and an E-wide scan of its pool
// for the earliest event, integer work on data the thread already
// holds (chip_smoke.py computes both terms for bound_ms). One thread per
// seed because seeds are independent and their control flow diverges
// per event (handlers, engine kinds, halts at different steps): SIMT
// absorbs that divergence, and no cross-thread exchange is needed. The
// thread-local arrays live in local memory (cached in L1/L2), since
// their indices are dynamic.
//
// Built by engine/fused.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//        --Werror cross-execution-space-call
// and loaded with ctypes: the C entry point below takes the field
// pointers, the config words, the card's index and the stream, and
// returns the launch's cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "engine_step.cuh"

#if !defined(MADSIM_MODEL) || !defined(MADSIM_POOLS)
#error "define MADSIM_MODEL and MADSIM_POOLS, then include run_kernel.cu"
#endif

namespace {

using Model = MADSIM_MODEL;
constexpr int kThreads = 128;

template <int E>
__global__ void __launch_bounds__(kThreads)
run_kernel(const madsim::RunArgs a, const typename Model::Params p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n_seeds) return;
  madsim::run_seed<Model, E>(a, p, i);
}

template <int E>
int launch(const madsim::RunArgs& a, const typename Model::Params& p,
           cudaStream_t stream) {
  const int64_t blocks = (a.n_seeds + kThreads - 1) / kThreads;
  run_kernel<E><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation for `pool`, or -1 when there is none
template <int... Es>
int launch_pool(int32_t pool, const madsim::RunArgs& a,
                const typename Model::Params& p, cudaStream_t stream) {
  int rc = -1;
  (void)((pool == Es && ((rc = launch<Es>(a, p, stream)), true)) || ...);
  return rc;
}

}  // namespace

extern "C" {

// ptrs: the RunArgs pointers in declaration order; cfg: the engine's
// config words, then the model's (Model::params). Returns a
// cudaError_t, or -1 for a pool size without an instantiation (the
// thread-local arrays need E at compile time; engine/fused.py lists the
// pools of each model).
int madsim_run(void* const* ptrs, const int64_t* cfg, int64_t n_seeds,
               int32_t pool, int32_t stop_at_halt, int32_t device,
               void* stream) {
  const madsim::RunArgs a = madsim::run_args(ptrs, cfg, n_seeds, stop_at_halt);
  const typename Model::Params p = Model::params(cfg + madsim::kEngineWords);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_seeds <= 0) return 0;
  // the stream belongs to the tensors' card
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return launch_pool<MADSIM_POOLS>(pool, a, p, s);
}

// the model's compile-time shape, for the wrapper to check against the
// workload: N, U, A, W, K, H, then the pointer count
void madsim_shape(int64_t* out) {
  out[0] = Model::N;
  out[1] = Model::U;
  out[2] = Model::A;
  out[3] = Model::W;
  out[4] = Model::K;
  out[5] = Model::H;
  out[6] = madsim::kRunPointers;
}

}  // extern "C"
