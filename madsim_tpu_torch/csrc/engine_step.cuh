// One seed of the batched engine: load, step, drain, run loop and store,
// generic over the workload.
//
// This is the body of the fused run kernel (run_kernel.cu), which
// replaces the JAX package's Pallas kernel
// madsim_tpu/engine/vmem.py:make_run_vmem. Every function here is
// MADSIM_HD: __host__ __device__ under nvcc, plain C++ under g++, so
// the same code also builds on a machine without a card and is held
// against the plain torch step there (tests/test_torch_kernel_host.py
// and the per-model tests).
//
// Semantics are those of madsim_tpu_torch/engine/core.py (the port's
// plain step, itself held bit for bit against the JAX engine): pop the
// first earliest valid slot; gate on liveness, epoch, clog and pause;
// run one handler or one engine kind; place the emits into free slots
// in pool order; fold the trace; advance the clock by the poll cost.
// Where the plain step evaluates every handler and every threefry lane
// and then selects, this code computes only what the selected path
// reads: a draw is a pure function of (seed, step, purpose), so the
// values are the same.
//
// The workload is a model trait M (model_*.cuh) with
//   static constexpr int N, U, A, W, K, H;  // nodes, row width, args
//                                           // words, payload words,
//                                           // emit slots, handlers
//   struct Params;                          // the factory's runtime words
//   static Params params(const int64_t* words);
//   static void handle(int32_t h, const Ctx<M>&, const Params&,
//                      int32_t* new_row, Emit<A, W>* emits);
// handle() starts from new_row == the node's row and K zeroed emit rows,
// and fills them in the order the torch handler's EmitBuilder calls
// (the row index keys the per-emit latency draw).
#pragma once

#include <stdint.h>

#include "threefry.cuh"

namespace madsim {

constexpr int64_t kInfNs = int64_t(1) << 62;

constexpr int32_t KIND_KILL = 0;
constexpr int32_t KIND_RESTART = 1;
constexpr int32_t KIND_CLOG = 2;
constexpr int32_t KIND_UNCLOG = 3;
constexpr int32_t KIND_CLOG_NODE = 4;
constexpr int32_t KIND_UNCLOG_NODE = 5;
constexpr int32_t KIND_HALT = 6;
constexpr int32_t KIND_NOP = 7;
constexpr int32_t KIND_PAUSE = 8;
constexpr int32_t KIND_RESUME = 9;
constexpr int32_t FIRST_USER_KIND = 10;
constexpr int32_t FIRST_EXT_KIND = 244;

constexpr uint32_t PURPOSE_POLL_COST = 0;
constexpr uint32_t PURPOSE_LATENCY = 8;
constexpr uint32_t PURPOSE_USER = 128;

constexpr uint64_t kTracePrime = 0x100000001B3ull;
constexpr uint64_t kTraceMix = 0x9E3779B97F4A7C15ull;

// the engine's words in front of the model's in the config array
constexpr int kEngineWords = 8;

// EngineConfig resolved on the host: spans are the uint32 modulo spans
// (0 already mapped to 1) and time_limit is 2^62 when the config has none
struct EngineConfig {
  int64_t lat_min;
  uint32_t lat_span;
  uint64_t loss_u32;  // in [0, 2^32]; 2^32 drops every send
  int64_t proc_min;
  uint32_t proc_span;
  int64_t backoff_min, backoff_max;
  int64_t time_limit;
};

// uint32 span of a [lo, hi) draw, as Draw._reduce: 0 draws from span 1
MADSIM_HDI uint32_t draw_span(int64_t lo, int64_t hi) {
  const uint32_t s = static_cast<uint32_t>(hi - lo);
  return s == 0 ? 1u : s;
}

// c: lat_min, lat_max, loss_u32, proc_min, proc_max, backoff_min,
//    backoff_max, time_limit_ns (0 = none)
inline EngineConfig engine_config(const int64_t* c) {
  EngineConfig e;
  e.lat_min = c[0];
  e.lat_span = draw_span(c[0], c[1]);
  e.loss_u32 = static_cast<uint64_t>(c[2]);
  e.proc_min = c[3];
  e.proc_span = draw_span(c[3], c[4]);
  e.backoff_min = c[5];
  e.backoff_max = c[6];
  e.time_limit = c[7] ? c[7] : kInfNs;
  return e;
}

// The kernel's view of the batch: one pointer per SimState field (the
// port's torch layout: seed-major, contiguous), the restart tables, the
// per-seed step budget and the per-seed iteration count it returns.
struct RunArgs {
  int64_t* seed;       // (S,) uint64 bits
  int64_t* now;        // (S,)
  int64_t* step;       // (S,) uint32 value
  uint8_t* halted;     // (S,)
  int64_t* halt_time;  // (S,)
  int64_t* trace;      // (S,) uint64 bits
  int32_t* overflow;   // (S,)
  int64_t* msg_count;  // (S,)
  int64_t* ev_time;    // (S,E)
  uint8_t* ev_valid;   // (S,E)
  int64_t* ev_meta;    // (S,E) uint32 value
  int32_t* ev_epoch;   // (S,E)
  int32_t* ev_args;    // (S,E,A)
  int32_t* ev_pay;     // (S,E,W); unused when W == 0
  uint8_t* alive;      // (S,N)
  uint8_t* paused;     // (S,N)
  int32_t* epoch;      // (S,N)
  int32_t* node_state; // (S,N,U)
  uint8_t* clog;       // (S,N,N)
  int32_t* slow;       // (S,N,N), read only
  int32_t* skew;       // (S,N), read only
  const int32_t* init_rows;  // (N,U)
  const uint8_t* volatile_cols;  // (U,)
  const int64_t* budget;  // (S,) steps this launch may take
  int64_t* iters;         // (S,) steps taken before a halt stopped it
  int64_t n_seeds;
  int32_t stop_at_halt;   // 1: a seed stops at its halt; 0: it drains
  EngineConfig cfg;
};

constexpr int kRunPointers = 25;

// p: the 25 pointers in RunArgs order (engine/fused.py KERNEL_FIELDS,
// then the tables, budget and iters); c: the engine's config words
inline RunArgs run_args(void* const* p, const int64_t* c, int64_t n_seeds,
                        int32_t stop_at_halt) {
  RunArgs a;
  a.seed = static_cast<int64_t*>(p[0]);
  a.now = static_cast<int64_t*>(p[1]);
  a.step = static_cast<int64_t*>(p[2]);
  a.halted = static_cast<uint8_t*>(p[3]);
  a.halt_time = static_cast<int64_t*>(p[4]);
  a.trace = static_cast<int64_t*>(p[5]);
  a.overflow = static_cast<int32_t*>(p[6]);
  a.msg_count = static_cast<int64_t*>(p[7]);
  a.ev_time = static_cast<int64_t*>(p[8]);
  a.ev_valid = static_cast<uint8_t*>(p[9]);
  a.ev_meta = static_cast<int64_t*>(p[10]);
  a.ev_epoch = static_cast<int32_t*>(p[11]);
  a.ev_args = static_cast<int32_t*>(p[12]);
  a.ev_pay = static_cast<int32_t*>(p[13]);
  a.alive = static_cast<uint8_t*>(p[14]);
  a.paused = static_cast<uint8_t*>(p[15]);
  a.epoch = static_cast<int32_t*>(p[16]);
  a.node_state = static_cast<int32_t*>(p[17]);
  a.clog = static_cast<uint8_t*>(p[18]);
  a.slow = static_cast<int32_t*>(p[19]);
  a.skew = static_cast<int32_t*>(p[20]);
  a.init_rows = static_cast<const int32_t*>(p[21]);
  a.volatile_cols = static_cast<const uint8_t*>(p[22]);
  a.budget = static_cast<const int64_t*>(p[23]);
  a.iters = static_cast<int64_t*>(p[24]);
  a.n_seeds = n_seeds;
  a.stop_at_halt = stop_at_halt;
  a.cfg = engine_config(c);
  return a;
}

MADSIM_HDI int32_t clampi(int32_t x, int32_t lo, int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// a // b rounded toward minus infinity, as jnp and torch divide ints
MADSIM_HDI int32_t floordiv(int32_t a, int32_t b) {
  const int32_t q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// one emit row (the port's Emits, one seed); a W == 0 row keeps a
// one-word payload array that no loop ever reads
template <int A, int W>
struct Emit {
  bool valid;
  bool send;
  int32_t kind;
  int32_t dst;
  int64_t delay;
  int32_t args[A];
  int32_t pay[W > 0 ? W : 1];

  MADSIM_HDI void clear() {
    valid = false;
    send = false;
    kind = 0;
    dst = 0;
    delay = 0;
    for (int j = 0; j < A; j++) args[j] = 0;
    for (int j = 0; j < W; j++) pay[j] = 0;
  }
  // EmitBuilder.send: a network message, args past a0/a1 zero
  MADSIM_HDI void to(bool when, int32_t d, int32_t k, int32_t a0 = 0,
                     int32_t a1 = 0) {
    valid = when;
    send = true;
    kind = k;
    dst = d;
    delay = 0;
    args[0] = a0;
    args[1] = a1;
  }
  // EmitBuilder.after: a timer `dl` ns after the dispatch
  MADSIM_HDI void after(bool when, int64_t dl, int32_t k, int32_t d,
                        int32_t a0 = 0, int32_t a1 = 0) {
    valid = when;
    send = false;
    kind = k;
    dst = d;
    delay = dl;
    args[0] = a0;
    args[1] = a1;
  }
};

// What a handler sees (the port's HandlerCtx, one seed), with the
// counter-based draws of engine/rng.py Draw.
template <class M>
struct Ctx {
  const int32_t* state;  // (U,) the node's row
  int32_t node, src;
  const int32_t* args;   // (A,)
  const int32_t* pay;    // (W,)
  int64_t now;           // the clock plus the node's skew
  uint32_t k0, k1, step;

  MADSIM_HDI uint32_t user(uint32_t purpose) const {
    uint32_t b0, b1;
    threefry2x32(k0, k1, step, PURPOSE_USER + purpose, &b0, &b1);
    return b0;
  }
  MADSIM_HDI int64_t user_int(int64_t lo, int64_t hi, uint32_t purpose) const {
    return lo + static_cast<int64_t>(user(purpose) % draw_span(lo, hi));
  }
};

// One seed's state, held in thread-local arrays for the whole run.
template <class M, int E>
struct Seed {
  static constexpr int N = M::N, U = M::U, A = M::A, W = M::W;
  uint64_t seed;
  int64_t now;
  uint32_t step;
  bool halted;
  int64_t halt_time;
  uint64_t trace;
  int32_t overflow;
  int64_t msg_count;
  int64_t ev_time[E];
  bool ev_valid[E];
  uint32_t ev_meta[E];
  int32_t ev_epoch[E];
  int32_t ev_args[E][A];
  int32_t ev_pay[E][W > 0 ? W : 1];
  bool alive[N];
  bool paused[N];
  int32_t epoch[N];
  int32_t skew[N];
  int32_t node_state[N][U];
  bool clog[N][N];
  int32_t slow[N][N];
};

template <class M, int E>
MADSIM_HD void seed_load(Seed<M, E>& s, const RunArgs& a, int64_t i) {
  constexpr int N = M::N, U = M::U, A = M::A, W = M::W;
  s.seed = static_cast<uint64_t>(a.seed[i]);
  s.now = a.now[i];
  s.step = static_cast<uint32_t>(a.step[i]);
  s.halted = a.halted[i] != 0;
  s.halt_time = a.halt_time[i];
  s.trace = static_cast<uint64_t>(a.trace[i]);
  s.overflow = a.overflow[i];
  s.msg_count = a.msg_count[i];
  for (int e = 0; e < E; e++) {
    const int64_t j = i * E + e;
    s.ev_time[e] = a.ev_time[j];
    s.ev_valid[e] = a.ev_valid[j] != 0;
    s.ev_meta[e] = static_cast<uint32_t>(a.ev_meta[j]);
    s.ev_epoch[e] = a.ev_epoch[j];
    for (int w = 0; w < A; w++) s.ev_args[e][w] = a.ev_args[j * A + w];
    for (int w = 0; w < W; w++) s.ev_pay[e][w] = a.ev_pay[j * W + w];
  }
  for (int n = 0; n < N; n++) {
    const int64_t j = i * N + n;
    s.alive[n] = a.alive[j] != 0;
    s.paused[n] = a.paused[j] != 0;
    s.epoch[n] = a.epoch[j];
    s.skew[n] = a.skew[j];
    for (int u = 0; u < U; u++) s.node_state[n][u] = a.node_state[j * U + u];
    for (int m = 0; m < N; m++) {
      s.clog[n][m] = a.clog[j * N + m] != 0;
      s.slow[n][m] = a.slow[j * N + m];
    }
  }
}

template <class M, int E>
MADSIM_HD void seed_store(const Seed<M, E>& s, const RunArgs& a, int64_t i) {
  constexpr int N = M::N, U = M::U, A = M::A, W = M::W;
  a.now[i] = s.now;
  a.step[i] = static_cast<int64_t>(s.step);
  a.halted[i] = s.halted ? 1 : 0;
  a.halt_time[i] = s.halt_time;
  a.trace[i] = static_cast<int64_t>(s.trace);
  a.overflow[i] = s.overflow;
  a.msg_count[i] = s.msg_count;
  for (int e = 0; e < E; e++) {
    const int64_t j = i * E + e;
    a.ev_time[j] = s.ev_time[e];
    a.ev_valid[j] = s.ev_valid[e] ? 1 : 0;
    a.ev_meta[j] = static_cast<int64_t>(s.ev_meta[e]);
    a.ev_epoch[j] = s.ev_epoch[e];
    for (int w = 0; w < A; w++) a.ev_args[j * A + w] = s.ev_args[e][w];
    for (int w = 0; w < W; w++) a.ev_pay[j * W + w] = s.ev_pay[e][w];
  }
  for (int n = 0; n < N; n++) {
    const int64_t j = i * N + n;
    a.alive[j] = s.alive[n] ? 1 : 0;
    a.paused[j] = s.paused[n] ? 1 : 0;
    a.epoch[j] = s.epoch[n];
    for (int u = 0; u < U; u++) a.node_state[j * U + u] = s.node_state[n][u];
    for (int m = 0; m < N; m++) a.clog[j * N + m] = s.clog[n][m] ? 1 : 0;
  }
}

template <class M, int E>
MADSIM_HDI int first_min(const Seed<M, E>& s) {
  int i = 0;
  int64_t best = kInfNs;
  for (int e = 0; e < E; e++) {
    const int64_t t = s.ev_valid[e] ? s.ev_time[e] : kInfNs;
    if (t < best) {
      best = t;
      i = e;
    }
  }
  return i;
}

// the port's _trace_fold: args word j shifted by 8j, and the payload
// term sum_j p_j * (MIX ^ j) mod 2^64 (absent when W == 0)
template <int A, int W>
MADSIM_HDI uint64_t trace_fold(uint64_t trace, int64_t now, int32_t kind,
                               int32_t node, const int32_t* args,
                               const int32_t* pay) {
  uint64_t h = static_cast<uint64_t>(now) * kTraceMix;
  h ^= static_cast<uint64_t>(static_cast<uint32_t>(kind)) << 32;
  h ^= static_cast<uint64_t>(static_cast<int64_t>(node)) << 40;
  for (int j = 0; j < A; j++)
    h ^= static_cast<uint64_t>(static_cast<uint32_t>(args[j])) << (8 * j);
  if (W > 0) {
    uint64_t acc = 0;
    for (int j = 0; j < W; j++)
      acc += static_cast<uint64_t>(static_cast<uint32_t>(pay[j])) *
             (kTraceMix ^ static_cast<uint64_t>(j));
    h ^= acc;
  }
  return trace * kTracePrime + h;
}

// One engine step. Returns false when the pool held no valid event:
// such a step changes nothing but `step`, and so does every later one.
template <class M, int E>
MADSIM_HD bool engine_step(Seed<M, E>& s, const EngineConfig& c,
                           const typename M::Params& mp,
                           const int32_t* init_rows,
                           const uint8_t* volatile_cols) {
  constexpr int N = M::N, U = M::U, A = M::A, W = M::W, K = M::K, H = M::H;
  static_assert(A >= 2 && A <= 4, "engine kinds read args[0:2]");
  static_assert(H >= 1, "handler 0 is on_init");
  // ev_meta packs the kind and node + 1 in one byte each
  static_assert(FIRST_USER_KIND + H - 1 < 256, "user kinds fit a byte");
  static_assert(N < 255, "node + 1 fits a byte");
  // ---- pop the earliest pending event (first minimum) ----
  const int i = first_min(s);
  const bool has_event = s.ev_valid[i];
  const int64_t ev_time_i = s.ev_time[i];
  const int64_t ev_t = ev_time_i > s.now ? ev_time_i : s.now;
  const bool over_limit = ev_t > c.time_limit;
  const bool active = has_event && !s.halted && !over_limit;

  const uint32_t meta = s.ev_meta[i];
  const int32_t kind = static_cast<int32_t>(meta & 0xFFu);
  const int32_t dst = static_cast<int32_t>((meta >> 8) & 0xFFu) - 1;
  const int32_t src = static_cast<int32_t>((meta >> 16) & 0xFFu) - 1;
  const int32_t retries = static_cast<int32_t>((meta >> 24) & 0xFFu);
  // the popped event's words, copied: placement may reuse its slot
  int32_t args[A];
  int32_t pay[W > 0 ? W : 1];
  for (int j = 0; j < A; j++) args[j] = s.ev_args[i][j];
  for (int j = 0; j < W; j++) pay[j] = s.ev_pay[i][j];
  const int32_t a0 = args[0];
  const int32_t ev_epoch_i = s.ev_epoch[i];
  const bool is_engine = kind < FIRST_USER_KIND || kind >= FIRST_EXT_KIND;
  const bool is_msg = src >= 0;
  const bool in_range = dst >= 0 && dst < N;
  const int dst_c = clampi(dst, 0, N - 1);
  const bool alive_dst = in_range && s.alive[dst_c];
  const bool paused_dst = in_range && s.paused[dst_c];
  const int32_t epoch_dst = in_range ? s.epoch[dst_c] : 0;
  const bool live =
      alive_dst && (epoch_dst == ev_epoch_i || ev_epoch_i == -1);
  const bool clogged =
      is_msg && in_range && s.clog[clampi(src, 0, N - 1)][dst_c];
  const bool held = !is_engine && paused_dst;
  const bool blocked = clogged || held;
  const bool dispatch = active && !blocked && (is_engine || live);
  const bool resched = active && blocked && (is_engine || live);

  const int64_t now = active ? ev_t : s.now;
  const uint32_t k0 = static_cast<uint32_t>(s.seed);
  const uint32_t k1 = static_cast<uint32_t>(s.seed >> 32);
  int64_t now_after = now;
  // poll cost (lane 0) and clog-recheck jitter (lane 1): one block
  if (dispatch || resched) {
    uint32_t b0, b1;
    threefry2x32(k0, k1, s.step, PURPOSE_POLL_COST, &b0, &b1);
    if (dispatch) now_after = now + c.proc_min + static_cast<int64_t>(b0 % c.proc_span);
    if (resched) {
      const int shift = retries < 34 ? retries : 34;
      int64_t backoff = static_cast<int64_t>(
          static_cast<uint64_t>(c.backoff_min) << shift);
      if (backoff > c.backoff_max) backoff = c.backoff_max;
      backoff += static_cast<int64_t>(b1 % 1000u);
      s.ev_time[i] = now + backoff;
      const uint32_t bumped = static_cast<uint32_t>(retries + 1 < 255 ? retries + 1 : 255);
      s.ev_meta[i] = (meta & 0x00FFFFFFu) | (bumped << 24);
    }
  }
  // consume the popped slot (a halted seed's step drains it too)
  s.ev_valid[i] = resched;

  if (dispatch) {
    Emit<A, W> em[K + 1];
    for (int j = 0; j <= K; j++) em[j].clear();
    if (!is_engine) {
      // user dispatch implies a live, in-range node
      int32_t ns[U];
      for (int u = 0; u < U; u++) ns[u] = s.node_state[dst_c][u];
      Ctx<M> ctx;
      ctx.state = s.node_state[dst_c];
      ctx.node = dst;
      ctx.src = src;
      ctx.args = args;
      ctx.pay = pay;
      ctx.now = now + static_cast<int64_t>(s.skew[dst_c]);
      ctx.k0 = k0;
      ctx.k1 = k1;
      ctx.step = s.step;
      M::handle(clampi(kind - FIRST_USER_KIND, 0, H - 1), ctx, mp, ns, em);
      for (int u = 0; u < U; u++) s.node_state[dst_c][u] = ns[u];
    } else if (kind == KIND_KILL || kind == KIND_RESTART) {
      const bool restart = kind == KIND_RESTART;
      if (a0 >= 0 && a0 < N) {
        s.alive[a0] = restart;
        s.paused[a0] = false;
        s.epoch[a0] += 1;
        if (restart) {
          for (int u = 0; u < U; u++)
            if (volatile_cols[u]) s.node_state[a0][u] = init_rows[a0 * U + u];
        }
      }
      // the reborn node re-runs on_init: a timer row after the user
      // slots, zero args and payload
      if (restart) em[K].after(true, 0, FIRST_USER_KIND, a0);
    } else if (kind == KIND_PAUSE || kind == KIND_RESUME) {
      if (a0 >= 0 && a0 < N) s.paused[a0] = kind == KIND_PAUSE;
    } else if (kind >= KIND_CLOG && kind <= KIND_UNCLOG_NODE) {
      const bool on = kind == KIND_CLOG || kind == KIND_CLOG_NODE;
      const bool node_wide = kind == KIND_CLOG_NODE || kind == KIND_UNCLOG_NODE;
      const int32_t ca = a0, cb = node_wide ? -1 : args[1];
      for (int x = 0; x < N; x++)
        for (int y = 0; y < N; y++) {
          const bool sel = (x == ca && y == cb) || (x == cb && y == ca) ||
                           (cb < 0 && (x == ca || y == ca));
          if (sel) s.clog[x][y] = on;
        }
    }

    // ---- emits: loss, dead destinations, latency; then compact
    // placement, the j-th valid emit into the j-th free slot ----
    int cursor = 0;
    for (int j = 0; j <= K; j++) {
      const Emit<A, W>& e = em[j];
      if (!e.valid) continue;
      const bool em_in_range = e.dst >= 0 && e.dst < N;
      const int em_c = clampi(e.dst, 0, N - 1);
      int64_t t;
      if (e.send) {
        s.msg_count += 1;
        uint32_t l0, l1;
        threefry2x32(k0, k1, s.step, PURPOSE_LATENCY + static_cast<uint32_t>(j), &l0, &l1);
        if (static_cast<uint64_t>(l1) < c.loss_u32) continue;  // lost
        if (!(em_in_range && s.alive[em_c])) continue;  // dead destination
        int64_t lat = c.lat_min + static_cast<int64_t>(l0 % c.lat_span);
        int32_t mult = (in_range && em_in_range) ? s.slow[dst_c][em_c] : 1;
        if (mult > 1) lat *= mult;
        t = now_after + lat;
      } else {
        t = now_after + e.delay;
      }
      const bool em_engine = e.kind < FIRST_USER_KIND || e.kind >= FIRST_EXT_KIND;
      const int32_t e_epoch = (em_engine || !em_in_range) ? 0 : s.epoch[em_c];
      const int32_t mk = e.kind < 0 ? KIND_NOP : (e.kind > 255 ? 255 : e.kind);
      const int32_t node1 = clampi(e.dst, -1, N) + 1;
      const int32_t src1 = e.send ? clampi(dst, -1, N) + 1 : 0;
      while (cursor < E && s.ev_valid[cursor]) cursor++;
      if (cursor >= E) {
        s.overflow += 1;
        continue;
      }
      s.ev_valid[cursor] = true;
      s.ev_time[cursor] = t;
      s.ev_meta[cursor] = static_cast<uint32_t>(mk) |
                          (static_cast<uint32_t>(node1) << 8) |
                          (static_cast<uint32_t>(src1) << 16);
      s.ev_epoch[cursor] = e_epoch;
      for (int w = 0; w < A; w++) s.ev_args[cursor][w] = e.args[w];
      for (int w = 0; w < W; w++) s.ev_pay[cursor][w] = e.pay[w];
      cursor++;
    }
  }

  // ---- halt, trace, clock ----
  const bool halted =
      s.halted || (dispatch && kind == KIND_HALT) || (has_event && over_limit);
  if (halted && !s.halted) s.halt_time = now < c.time_limit ? now : c.time_limit;
  s.halted = halted;
  if (dispatch) s.trace = trace_fold<A, W>(s.trace, now, kind, dst, args, pay);
  s.now = now_after;
  s.step += 1u;
  return has_event;
}

// `r` steps of a halted seed: each consumes its earliest valid slot
// without dispatching it, and advances `step`
template <class M, int E>
MADSIM_HD void seed_drain(Seed<M, E>& s, int64_t r) {
  int64_t n_valid = 0;
  for (int e = 0; e < E; e++) n_valid += s.ev_valid[e] ? 1 : 0;
  if (r >= n_valid) {
    for (int e = 0; e < E; e++) s.ev_valid[e] = false;
  } else {
    for (int64_t k = 0; k < r; k++) s.ev_valid[first_min(s)] = false;
  }
  s.step += static_cast<uint32_t>(r);
}

// Up to `budget` steps of one seed. With stop_at_halt the seed stops at
// its halt and the return value is the steps it took; without, it takes
// all `budget` steps (a halted seed drains). Either way each iteration
// advances `step` exactly as the plain step would.
template <class M, int E>
MADSIM_HD int64_t seed_run(Seed<M, E>& s, const EngineConfig& c,
                           const typename M::Params& mp,
                           const int32_t* init_rows,
                           const uint8_t* volatile_cols, int64_t budget,
                           bool stop_at_halt) {
  int64_t it = 0;
  while (it < budget) {
    if (s.halted) {
      if (stop_at_halt) return it;
      seed_drain(s, budget - it);
      return budget;
    }
    const bool had_event = engine_step(s, c, mp, init_rows, volatile_cols);
    it++;
    if (!had_event && !s.halted) {
      // an empty pool stays empty: the rest only counts steps
      s.step += static_cast<uint32_t>(budget - it);
      return budget;
    }
  }
  return it;
}

template <class M, int E>
MADSIM_HD void run_seed(const RunArgs& a, const typename M::Params& mp,
                        int64_t i) {
  const int64_t budget = a.budget[i];
  if (budget <= 0) {
    a.iters[i] = 0;
    return;
  }
  Seed<M, E> s;
  seed_load(s, a, i);
  a.iters[i] = seed_run(s, a.cfg, mp, a.init_rows, a.volatile_cols, budget,
                        a.stop_at_halt != 0);
  seed_store(s, a, i);
}

}  // namespace madsim
