// The fused run kernel for the raft election workload on Hopper (sm_90a).
//
// Replaces madsim_tpu/engine/vmem.py:make_run_vmem, the JAX package's
// one Pallas kernel, which keeps each block of seeds' SimState in VMEM
// for all n_steps of vmap(make_step). Here one CUDA thread runs one
// seed: it loads the seed's row once, keeps its event pool, node rows
// and clog matrix in thread-local arrays for the whole loop
// (step_raft.cuh), and stores the row once.
//
// What bounds it: device memory sees one load and one store of the
// state per launch; per step a seed does a few threefry blocks (20
// rounds of 32-bit add/rotate/xor each) and an E-wide scan of its pool
// for the earliest event, integer work on data the thread already
// holds. At the raft bench shape the two terms are of the same size
// (chip_smoke.py computes both for bound_ms; on an H100 the bytes term
// is the larger). One thread per seed because seeds are independent and
// their control flow diverges per event (five handlers, engine kinds,
// halts at different steps): SIMT absorbs that divergence, and no
// cross-thread exchange is needed. The thread-local arrays live in
// local memory (cached in L1/L2), since their indices are dynamic.
//
// Built by engine/fused.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes: the C entry point below takes the field
// pointers, the config words, the card's index and the stream, and
// returns the launch's cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "step_raft.cuh"

namespace {

constexpr int kThreads = 128;

template <int E>
__global__ void __launch_bounds__(kThreads)
raft_run_kernel(const madsim::RaftArgs a) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n_seeds) return;
  madsim::raft_run_seed<E>(a, i);
}

template <int E>
cudaError_t launch(const madsim::RaftArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.n_seeds + kThreads - 1) / kThreads;
  raft_run_kernel<E><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: the 23 RaftArgs pointers in declaration order; cfg: the 10
// config words (step_raft.cuh raft_args). Returns a cudaError_t, or -1
// for a pool size without an instantiation (the thread-local arrays
// need E at compile time; engine/fused.py POOL_SIZES lists them).
int madsim_raft_run(void* const* ptrs, const int64_t* cfg, int64_t n_seeds,
                    int32_t pool, int32_t stop_at_halt, int32_t device,
                    void* stream) {
  const madsim::RaftArgs a = madsim::raft_args(ptrs, cfg, n_seeds, stop_at_halt);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_seeds <= 0) return 0;
  // the stream belongs to the tensors' card
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  switch (pool) {
    case 40: return static_cast<int>(launch<40>(a, s));
    case 64: return static_cast<int>(launch<64>(a, s));
    case 128: return static_cast<int>(launch<128>(a, s));
    case 256: return static_cast<int>(launch<256>(a, s));
    default: return -1;
  }
}

}  // extern "C"
