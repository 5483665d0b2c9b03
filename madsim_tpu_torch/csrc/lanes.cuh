// A lane group: G lanes of one warp that run one seed together.
//
// The run kernel (run_kernel.cu) gives each seed G consecutive lanes.
// The lanes split the seed's pool scans and its emit rows between them
// and meet in shuffles and ballots over the group's own mask, never a
// full-warp mask: the groups of one warp halt at different steps, and a
// group that has left its step loop takes no further part in a shuffle.
//
// Every primitive is MADSIM_HD. On the card (__CUDA_ARCH__) a lane runs
// its own share; anywhere else the one calling thread plays all G lanes
// in turn, each over the same share of slots or rows as on the card, and
// combines their results in the order the card's butterfly does. That
// serial form exists so that g++ can build the step for the tests
// (tests/_torch_host.py); a CUDA state never reaches it.
//
// Code that uses a group is written lane by lane: `g.each(f)` calls
// f(lane) for the thread's own lane on the card and for every lane on
// the host, `PerLane<T, G>` holds one value per lane (a register on the
// card), and `g.leader()` marks what one lane does for the whole group.
// A write that other lanes read is followed by `g.sync()`.
#pragma once

#include <stdint.h>

#include "threefry.cuh"

namespace madsim {

// the pool's empty-slot key, 2^62 ns
constexpr int64_t kInfNs = int64_t(1) << 62;

MADSIM_HDI int popc32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// the position of the (r+1)-th set bit of x; r < popc32(x). A binary
// search on popcounts: five steps, where __fns loops on the card
MADSIM_HDI int nth_set_bit(uint32_t x, int r) {
  int pos = 0;
  for (int w = 16; w > 0; w /= 2) {
    const int c = popc32(x & ((1u << w) - 1u));
    if (r >= c) {
      r -= c;
      x >>= w;
      pos += w;
    }
  }
  return pos;
}

// one value per lane of the group: the lane's register on the card,
// an array of G on the host
template <class T, int G>
struct PerLane {
#ifdef __CUDA_ARCH__
  T v;
  MADSIM_HDI T& operator[](int) { return v; }
  MADSIM_HDI const T& operator[](int) const { return v; }
#else
  T v[G];
  MADSIM_HDI T& operator[](int l) { return v[l]; }
  MADSIM_HDI const T& operator[](int l) const { return v[l]; }
#endif
};

// a slot key for the first minimum: (time, index) in lexicographic order
struct SlotKey {
  int64_t t;
  int32_t i;
  MADSIM_HDI bool before(const SlotKey& o) const {
    return t < o.t || (t == o.t && i < o.i);
  }
};

template <int G>
struct Lanes {
  static_assert(G == 4 || G == 8 || G == 16 || G == 32,
                "a group is 4, 8, 16 or 32 lanes of one warp");
  int lane;       // the thread's rank in its group (on the card)
  uint32_t mask;  // the group's lanes within the warp (on the card)

  // `thread`: the thread's index in its block; a block is a whole
  // number of warps, so a group never straddles two
  MADSIM_HDI explicit Lanes(int thread) {
    lane = thread & (G - 1);
    const int first = (thread & 31) & ~(G - 1);
    mask = (G == 32 ? 0xFFFFFFFFu : ((1u << G) - 1u)) << first;
  }

  MADSIM_HDI bool leader() const {
#ifdef __CUDA_ARCH__
    return lane == 0;
#else
    return true;
#endif
  }

  MADSIM_HDI void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp(mask);
#endif
  }

  template <class F>
  MADSIM_HDI void each(F f) const {
#ifdef __CUDA_ARCH__
    f(lane);
#else
    for (int l = 0; l < G; l++) f(l);
#endif
  }

  // bit l set where lane l's value holds
  MADSIM_HDI uint32_t ballot(const PerLane<bool, G>& p) const {
#ifdef __CUDA_ARCH__
    const uint32_t all = __ballot_sync(mask, p.v);
    return (all & mask) >> (__ffs(mask) - 1);
#else
    uint32_t b = 0;
    for (int l = 0; l < G; l++) b |= static_cast<uint32_t>(p.v[l]) << l;
    return b;
#endif
  }

  // the group's sum, on every lane
  MADSIM_HDI int sum(const PerLane<int, G>& p) const {
#ifdef __CUDA_ARCH__
    int x = p.v;
    for (int off = G / 2; off > 0; off /= 2) x += __shfl_xor_sync(mask, x, off, G);
    return x;
#else
    int v[G];
    for (int l = 0; l < G; l++) v[l] = p.v[l];
    for (int off = G / 2; off > 0; off /= 2) {
      int n[G];
      for (int l = 0; l < G; l++) n[l] = v[l] + v[l ^ off];
      for (int l = 0; l < G; l++) v[l] = n[l];
    }
    return v[0];
#endif
  }

  // the group's first minimum by (time, index), on every lane
  MADSIM_HDI SlotKey min(const PerLane<SlotKey, G>& p) const {
#ifdef __CUDA_ARCH__
    SlotKey k = p.v;
    for (int off = G / 2; off > 0; off /= 2) {
      SlotKey o;
      o.t = __shfl_xor_sync(mask, static_cast<long long>(k.t), off, G);
      o.i = __shfl_xor_sync(mask, k.i, off, G);
      if (o.before(k)) k = o;
    }
    return k;
#else
    SlotKey v[G];
    for (int l = 0; l < G; l++) v[l] = p.v[l];
    for (int off = G / 2; off > 0; off /= 2) {
      SlotKey n[G];
      for (int l = 0; l < G; l++) n[l] = v[l ^ off].before(v[l]) ? v[l ^ off] : v[l];
      for (int l = 0; l < G; l++) v[l] = n[l];
    }
    return v[0];
#endif
  }
};

// ---- the pool's valid bits: E bits in words of 32 ----

template <int E>
struct PoolBits {
  static constexpr int NW = (E + 31) / 32;
  // the bits of word w that name a slot
  static MADSIM_HDI uint32_t in_range(int w) {
    const int rest = E - 32 * w;
    return rest >= 32 ? 0xFFFFFFFFu : ((1u << rest) - 1u);
  }
  static MADSIM_HDI bool get(const uint32_t* bits, int e) {
    return (bits[e >> 5] >> (e & 31)) & 1u;
  }
  // the r-th free slot (from 0) in index order, or -1
  static MADSIM_HDI int nth_free(const uint32_t* bits, int r) {
    for (int w = 0; w < NW; w++) {
      const uint32_t z = ~bits[w] & in_range(w);
      const int c = popc32(z);
      if (r < c) return 32 * w + nth_set_bit(z, r);
      r -= c;
    }
    return -1;
  }
  // mark the first n free slots valid; returns how many there were
  static MADSIM_HDI int fill_first_free(uint32_t* bits, int n) {
    int placed = 0;
    for (int w = 0; w < NW && n > 0; w++) {
      const uint32_t z = ~bits[w] & in_range(w);
      const int c = popc32(z);
      if (n >= c) {
        bits[w] |= z;
        n -= c;
        placed += c;
      } else {
        bits[w] |= z & ((1u << nth_set_bit(z, n)) - 1u);
        placed += n;
        n = 0;
      }
    }
    return placed;
  }
};

// clear bit e of a word that other lanes may clear at the same time
MADSIM_HDI void clear_bit_shared(uint32_t* bits, int e) {
#ifdef __CUDA_ARCH__
  atomicAnd(&bits[e >> 5], ~(1u << (e & 31)));
#else
  bits[e >> 5] &= ~(1u << (e & 31));
#endif
}

// set bit e of a word that other threads may set at the same time
MADSIM_HDI void set_bit_shared(uint32_t* bits, int e) {
#ifdef __CUDA_ARCH__
  atomicOr(&bits[e >> 5], 1u << (e & 31));
#else
  bits[e >> 5] |= 1u << (e & 31);
#endif
}

// The pop of the plain step: the first minimum of (valid ? time :
// kInf) over the pool, as torch's and jnp's argmin take it. Lane l scans
// slots l, l + G, ...; the group keeps the first minimum by (time,
// index). A valid slot at exactly kInf ties with the empty slots, and
// one later than kInf loses to them.
template <int E, int G>
MADSIM_HDI int pop_slot(const Lanes<G>& g, const uint32_t* bits,
                        const int64_t* time) {
  PerLane<SlotKey, G> k;
  g.each([&](int l) {
    SlotKey b{INT64_MAX, E};
    for (int e = l; e < E; e += G) {
      const int64_t t = PoolBits<E>::get(bits, e) ? time[e] : kInfNs;
      if (t < b.t) b = SlotKey{t, e};
    }
    k[l] = b;
  });
  return g.min(k).i;
}

// `r` steps of a halted seed. Each pops as pop_slot does and clears the
// popped slot. The live slots (valid, earlier than kInf) go first, in
// (time, index) order: a slot is cleared when fewer than r live slots
// come before it, and each lane ranks its own slots, so the pool is
// scanned once, not once for each step. A step past the live slots pops
// the first slot whose key is kInf (an empty one, or one valid at
// exactly kInf), or, where every slot is valid and later than kInf, the
// first minimum of them; it clears that slot, and every later step pops
// the same, now empty, slot. `time` is read only where a slot is valid.
template <int E, int G>
MADSIM_HD void drain_slots(const Lanes<G>& g, uint32_t* bits,
                           const int64_t* time, int64_t r) {
  constexpr int64_t inf = kInfNs;
  constexpr int PER = (E + G - 1) / G;
  static_assert(PER <= 64, "a lane's slots fit one 64-bit mask");
  using B = PoolBits<E>;
  PerLane<int, G> own;
  g.each([&](int l) {
    int n = 0;
    for (int e = l; e < E; e += G) n += (B::get(bits, e) && time[e] < inf) ? 1 : 0;
    own[l] = n;
  });
  const int n_live = g.sum(own);
  // which of its slots each lane clears (bit c: slot l + c G), decided
  // before any bit changes
  PerLane<uint64_t, G> drop;
  g.each([&](int l) {
    uint64_t d = 0;
    int c = 0;
    for (int e = l; e < E; e += G, c++) {
      if (!B::get(bits, e)) continue;
      const int64_t t = time[e];
      if (t >= inf) continue;
      bool gone = r >= n_live;
      if (!gone) {
        int64_t rank = 0;
        for (int f = 0; f < E; f++) {
          if (f == e || !B::get(bits, f)) continue;
          const int64_t u = time[f];
          rank += (u < t || (u == t && f < e)) ? 1 : 0;
        }
        gone = rank < r;
      }
      if (gone) d |= uint64_t(1) << c;
    }
    drop[l] = d;
  });
  g.sync();
  g.each([&](int l) {
    int c = 0;
    for (int e = l; e < E; e += G, c++)
      if ((drop[l] >> c) & 1u) clear_bit_shared(bits, e);
  });
  g.sync();
  if (r > n_live && g.leader()) {
    int pick = -1;
    for (int e = 0; e < E && pick < 0; e++)
      if (!B::get(bits, e) || time[e] == inf) pick = e;
    if (pick < 0) {  // a full pool, every slot later than kInf
      SlotKey best{INT64_MAX, E};
      for (int e = 0; e < E; e++)
        if (time[e] < best.t) best = SlotKey{time[e], e};
      pick = best.i;
    }
    bits[pick >> 5] &= ~(1u << (pick & 31));
  }
  g.sync();
}

}  // namespace madsim
