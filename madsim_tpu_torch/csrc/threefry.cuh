// Threefry-2x32-20, the engine's counter-based generator, as code that
// builds for the card (nvcc) and for the host (g++).
//
// The same function as madsim_tpu_torch/engine/rng.py threefry2x32 and
// the JAX package's engine/rng.py: key = the seed's two 32-bit words,
// counter = (event step, purpose), twenty rounds in five chunks of four
// with the Skein key schedule.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define MADSIM_HD __host__ __device__
#define MADSIM_HDI __host__ __device__ __forceinline__
#else
#define MADSIM_HD
#define MADSIM_HDI inline
#endif

namespace madsim {

constexpr uint32_t kParity = 0x1BD11BDAu;

MADSIM_HDI uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

MADSIM_HDI void threefry2x32(uint32_t k0, uint32_t k1, uint32_t x0,
                             uint32_t x1, uint32_t* o0, uint32_t* o1) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  x0 += k0;
  x1 += k1;
#define MADSIM_TF_ROUND(r) \
  x0 += x1;                \
  x1 = rotl32(x1, r);      \
  x1 ^= x0;
#define MADSIM_TF_EVEN \
  MADSIM_TF_ROUND(13) MADSIM_TF_ROUND(15) MADSIM_TF_ROUND(26) MADSIM_TF_ROUND(6)
#define MADSIM_TF_ODD \
  MADSIM_TF_ROUND(17) MADSIM_TF_ROUND(29) MADSIM_TF_ROUND(16) MADSIM_TF_ROUND(24)
  // chunk c adds ks[(c+1)%3] to x0 and ks[(c+2)%3] + c + 1 to x1
  MADSIM_TF_EVEN x0 += k1; x1 += k2 + 1u;
  MADSIM_TF_ODD  x0 += k2; x1 += k0 + 2u;
  MADSIM_TF_EVEN x0 += k0; x1 += k1 + 3u;
  MADSIM_TF_ODD  x0 += k1; x1 += k2 + 4u;
  MADSIM_TF_EVEN x0 += k2; x1 += k0 + 5u;
#undef MADSIM_TF_EVEN
#undef MADSIM_TF_ODD
#undef MADSIM_TF_ROUND
  *o0 = x0;
  *o1 = x1;
}

}  // namespace madsim
