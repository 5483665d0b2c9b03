// One seed of the batched engine running the raft election workload:
// the per-seed step, the run loop, and the raft handlers as device code.
//
// This is the body of the fused run kernel (run_kernel.cu), which
// replaces the JAX package's Pallas kernel
// madsim_tpu/engine/vmem.py:make_run_vmem. Every function here is
// MADSIM_HD: __host__ __device__ under nvcc, plain C++ under g++, so
// the same code also builds on a machine without a card and is held
// against the plain torch step there (tests/test_torch_kernel_host.py).
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
#pragma once

#include <stdint.h>

#include "threefry.cuh"

namespace madsim {

constexpr int RAFT_N = 5;             // nodes
constexpr int RAFT_U = 6;             // state row width
constexpr int RAFT_A = 2;             // event args words
constexpr int RAFT_K = RAFT_N + 1;    // emit slots per handler
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

// EngineConfig plus the raft factory's timeouts, resolved on the host:
// spans are the uint32 modulo spans (0 already mapped to 1) and
// time_limit is 2^62 when the config has none
struct RaftConfig {
  int64_t lat_min;
  uint32_t lat_span;
  uint64_t loss_u32;  // in [0, 2^32]; 2^32 drops every send
  int64_t proc_min;
  uint32_t proc_span;
  int64_t backoff_min, backoff_max;
  int64_t time_limit;
  int64_t timeout_min;
  uint32_t timeout_span;
};

// The kernel's view of the batch: one pointer per SimState field (the
// port's torch layout: seed-major, contiguous), the restart tables, the
// per-seed step budget and the per-seed iteration count it returns.
struct RaftArgs {
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
  uint8_t* alive;      // (S,N)
  uint8_t* paused;     // (S,N)
  int32_t* epoch;      // (S,N)
  int32_t* node_state; // (S,N,U)
  uint8_t* clog;       // (S,N,N)
  int32_t* slow;       // (S,N,N)
  const int32_t* init_rows;  // (N,U)
  const uint8_t* volatile_cols;  // (U,)
  const int64_t* budget;  // (S,) steps this launch may take
  int64_t* iters;         // (S,) steps taken before a halt stopped it
  int64_t n_seeds;
  int32_t stop_at_halt;   // 1: a seed stops at its halt; 0: it drains
  RaftConfig cfg;
};

// p: the 23 pointers in RaftArgs order (engine/fused.py KERNEL_FIELDS,
// then the tables, budget and iters); c: the 10 config words
inline RaftArgs raft_args(void* const* p, const int64_t* c, int64_t n_seeds,
                          int32_t stop_at_halt) {
  RaftArgs a;
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
  a.alive = static_cast<uint8_t*>(p[13]);
  a.paused = static_cast<uint8_t*>(p[14]);
  a.epoch = static_cast<int32_t*>(p[15]);
  a.node_state = static_cast<int32_t*>(p[16]);
  a.clog = static_cast<uint8_t*>(p[17]);
  a.slow = static_cast<int32_t*>(p[18]);
  a.init_rows = static_cast<const int32_t*>(p[19]);
  a.volatile_cols = static_cast<const uint8_t*>(p[20]);
  a.budget = static_cast<const int64_t*>(p[21]);
  a.iters = static_cast<int64_t*>(p[22]);
  a.n_seeds = n_seeds;
  a.stop_at_halt = stop_at_halt;
  // c: lat_min, lat_max, loss_u32, proc_min, proc_max, backoff_min,
  //    backoff_max, time_limit_ns (0 = none), timeout_min, timeout_max
  auto span = [](int64_t lo, int64_t hi) {
    uint32_t s = static_cast<uint32_t>(hi - lo);
    return s == 0 ? 1u : s;
  };
  a.cfg.lat_min = c[0];
  a.cfg.lat_span = span(c[0], c[1]);
  a.cfg.loss_u32 = static_cast<uint64_t>(c[2]);
  a.cfg.proc_min = c[3];
  a.cfg.proc_span = span(c[3], c[4]);
  a.cfg.backoff_min = c[5];
  a.cfg.backoff_max = c[6];
  a.cfg.time_limit = c[7] ? c[7] : kInfNs;
  a.cfg.timeout_min = c[8];
  a.cfg.timeout_span = span(c[8], c[9]);
  return a;
}

MADSIM_HDI int32_t clampi(int32_t x, int32_t lo, int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// one emit row (the port's Emits, one seed)
struct Emit {
  bool valid;
  bool send;
  int32_t kind;
  int32_t dst;
  int64_t delay;
  int32_t a0, a1;
};

// One seed's state, held in thread-local arrays for the whole run.
template <int E>
struct RaftSeed {
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
  int32_t ev_args[E][RAFT_A];
  bool alive[RAFT_N];
  bool paused[RAFT_N];
  int32_t epoch[RAFT_N];
  int32_t node_state[RAFT_N][RAFT_U];
  bool clog[RAFT_N][RAFT_N];
  int32_t slow[RAFT_N][RAFT_N];
};

template <int E>
MADSIM_HD void raft_load(RaftSeed<E>& s, const RaftArgs& a, int64_t i) {
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
    s.ev_args[e][0] = a.ev_args[j * RAFT_A];
    s.ev_args[e][1] = a.ev_args[j * RAFT_A + 1];
  }
  for (int n = 0; n < RAFT_N; n++) {
    const int64_t j = i * RAFT_N + n;
    s.alive[n] = a.alive[j] != 0;
    s.paused[n] = a.paused[j] != 0;
    s.epoch[n] = a.epoch[j];
    for (int u = 0; u < RAFT_U; u++)
      s.node_state[n][u] = a.node_state[j * RAFT_U + u];
    for (int m = 0; m < RAFT_N; m++) {
      s.clog[n][m] = a.clog[j * RAFT_N + m] != 0;
      s.slow[n][m] = a.slow[j * RAFT_N + m];
    }
  }
}

template <int E>
MADSIM_HD void raft_store(const RaftSeed<E>& s, const RaftArgs& a, int64_t i) {
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
    a.ev_args[j * RAFT_A] = s.ev_args[e][0];
    a.ev_args[j * RAFT_A + 1] = s.ev_args[e][1];
  }
  for (int n = 0; n < RAFT_N; n++) {
    const int64_t j = i * RAFT_N + n;
    a.alive[j] = s.alive[n] ? 1 : 0;
    a.paused[j] = s.paused[n] ? 1 : 0;
    a.epoch[j] = s.epoch[n];
    for (int u = 0; u < RAFT_U; u++)
      a.node_state[j * RAFT_U + u] = s.node_state[n][u];
    for (int m = 0; m < RAFT_N; m++)
      a.clog[j * RAFT_N + m] = s.clog[n][m] ? 1 : 0;
  }
}

// ---- the raft handlers (madsim_tpu_torch/models/raft.py) ----------------

constexpr int32_t ROLE = 0, TERM = 1, VOTED = 2, VOTES = 3, TSEQ = 4;
constexpr int32_t FOLLOWER = 0, CANDIDATE = 1, LEADER = 2;
constexpr int32_t K_TIMEOUT = FIRST_USER_KIND + 1;
constexpr int32_t K_REQVOTE = FIRST_USER_KIND + 2;
constexpr int32_t K_GRANT = FIRST_USER_KIND + 3;
constexpr int32_t K_HEARTBEAT = FIRST_USER_KIND + 4;

MADSIM_HDI void emit_send(Emit& e, bool when, int32_t dst, int32_t kind,
                          int32_t a0, int32_t a1) {
  e.valid = when;
  e.send = true;
  e.kind = kind;
  e.dst = dst;
  e.delay = 0;
  e.a0 = a0;
  e.a1 = a1;
}

MADSIM_HDI void emit_after(Emit& e, bool when, int64_t delay, int32_t kind,
                           int32_t dst, int32_t a0) {
  e.valid = when;
  e.send = false;
  e.kind = kind;
  e.dst = dst;
  e.delay = delay;
  e.a0 = a0;
  e.a1 = 0;
}

// the election timeout draw: user purpose 0, drawn only when its timer
// row is valid (an invalid row's delay is never read)
MADSIM_HDI int64_t raft_timeout(uint32_t k0, uint32_t k1, uint32_t step,
                                const RaftConfig& c) {
  uint32_t b0, b1;
  threefry2x32(k0, k1, step, PURPOSE_USER + 0u, &b0, &b1);
  return c.timeout_min + static_cast<int64_t>(b0 % c.timeout_span);
}

// handler h on row st of node `node`: writes the new row to ns and the
// K emit slots in the order the torch handlers fill them
MADSIM_HD inline void raft_handler(int32_t h, const int32_t* st, int32_t node,
                            int32_t a0, int32_t a1, uint32_t k0, uint32_t k1,
                            uint32_t step, const RaftConfig& c, int32_t* ns,
                            Emit* em) {
  constexpr int32_t majority = RAFT_N / 2 + 1;
  switch (h) {
    case 0: {  // on_init
      emit_after(em[0], true, raft_timeout(k0, k1, step, c), K_TIMEOUT, node, 1);
      ns[TSEQ] = 1;
      break;
    }
    case 1: {  // on_timeout: args = (timeout_seq,)
      const bool fire = a0 == st[TSEQ] && st[ROLE] != LEADER;
      const int32_t term = st[TERM] + 1;
      if (fire) {
        ns[ROLE] = CANDIDATE;
        ns[TERM] = term;
        ns[VOTED] = term;
        ns[VOTES] = 1;
        ns[TSEQ] = st[TSEQ] + 1;
      }
      for (int32_t p = 0; p < RAFT_N; p++)
        emit_send(em[p], fire && p != node, p, K_REQVOTE, term, node);
      emit_after(em[RAFT_N], fire,
                 fire ? raft_timeout(k0, k1, step, c) : 0, K_TIMEOUT, node,
                 st[TSEQ] + 1);
      break;
    }
    case 2: {  // on_reqvote: args = (term, candidate)
      const int32_t term = a0, cand = a1;
      int32_t st1[RAFT_U];
      for (int u = 0; u < RAFT_U; u++) st1[u] = st[u];
      if (term > st[TERM]) {  // step down on a newer term
        st1[TERM] = term;
        st1[ROLE] = FOLLOWER;
        st1[VOTES] = 0;
      }
      const bool grant = term == st1[TERM] && st1[VOTED] < term;
      for (int u = 0; u < RAFT_U; u++) ns[u] = st1[u];
      if (grant) {
        ns[VOTED] = term;
        ns[TSEQ] = st1[TSEQ] + 1;
      }
      emit_send(em[0], grant, cand, K_GRANT, term, 0);
      // granting resets the election timer (vote then wait)
      emit_after(em[1], grant, grant ? raft_timeout(k0, k1, step, c) : 0,
                 K_TIMEOUT, node, st1[TSEQ] + 1);
      break;
    }
    case 3: {  // on_grant: args = (term,)
      const int32_t term = a0;
      const bool counts = st[ROLE] == CANDIDATE && term == st[TERM];
      const int32_t votes = counts ? st[VOTES] + 1 : st[VOTES];
      const bool wins = counts && votes >= majority;
      ns[VOTES] = votes;
      if (wins) ns[ROLE] = LEADER;
      for (int32_t p = 0; p < RAFT_N; p++)
        emit_send(em[p], wins && p != node, p, K_HEARTBEAT, term, 0);
      // leader elected: scenario complete
      emit_after(em[RAFT_N], wins, 0, KIND_HALT, 0, 0);
      break;
    }
    default: {  // 4, on_heartbeat: args = (term,)
      const int32_t term = a0;
      const bool accept = term >= st[TERM];
      if (accept) {
        ns[TERM] = term;
        ns[ROLE] = FOLLOWER;
        ns[TSEQ] = st[TSEQ] + 1;
      }
      emit_after(em[0], accept, accept ? raft_timeout(k0, k1, step, c) : 0,
                 K_TIMEOUT, node, st[TSEQ] + 1);
      break;
    }
  }
}

// ---- the engine step (madsim_tpu_torch/engine/core.py _plain_step_fn) ---

template <int E>
MADSIM_HDI int raft_first_min(const RaftSeed<E>& s) {
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

MADSIM_HDI uint64_t trace_fold(uint64_t trace, int64_t now, int32_t kind,
                               int32_t node, int32_t a0, int32_t a1) {
  uint64_t h = static_cast<uint64_t>(now) * kTraceMix;
  h ^= static_cast<uint64_t>(static_cast<uint32_t>(kind)) << 32;
  h ^= static_cast<uint64_t>(static_cast<int64_t>(node)) << 40;
  h ^= static_cast<uint64_t>(static_cast<uint32_t>(a0));
  h ^= static_cast<uint64_t>(static_cast<uint32_t>(a1)) << 8;
  return trace * kTracePrime + h;
}

// One engine step. Returns false when the pool held no valid event:
// such a step changes nothing but `step`, and so does every later one.
template <int E>
MADSIM_HD bool raft_step(RaftSeed<E>& s, const RaftConfig& c,
                         const int32_t* init_rows,
                         const uint8_t* volatile_cols) {
  constexpr int N = RAFT_N, K = RAFT_K;
  // ---- pop the earliest pending event (first minimum) ----
  const int i = raft_first_min(s);
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
  const int32_t a0 = s.ev_args[i][0], a1 = s.ev_args[i][1];
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
    Emit em[K + 1];
    for (int j = 0; j <= K; j++) em[j].valid = false;
    if (!is_engine) {
      // user dispatch implies a live, in-range node
      int32_t ns[RAFT_U];
      for (int u = 0; u < RAFT_U; u++) ns[u] = s.node_state[dst_c][u];
      const int32_t h = clampi(kind - FIRST_USER_KIND, 0, 4);
      raft_handler(h, s.node_state[dst_c], dst, a0, a1, k0, k1, s.step, c, ns, em);
      for (int u = 0; u < RAFT_U; u++) s.node_state[dst_c][u] = ns[u];
    } else if (kind == KIND_KILL || kind == KIND_RESTART) {
      const bool restart = kind == KIND_RESTART;
      if (a0 >= 0 && a0 < N) {
        s.alive[a0] = restart;
        s.paused[a0] = false;
        s.epoch[a0] += 1;
        if (restart) {
          for (int u = 0; u < RAFT_U; u++)
            if (volatile_cols[u]) s.node_state[a0][u] = init_rows[a0 * RAFT_U + u];
        }
      }
      if (restart) {
        // the reborn node re-runs on_init: a timer row after the user slots
        emit_after(em[K], true, 0, FIRST_USER_KIND, a0, 0);
      }
    } else if (kind == KIND_PAUSE || kind == KIND_RESUME) {
      if (a0 >= 0 && a0 < N) s.paused[a0] = kind == KIND_PAUSE;
    } else if (kind >= KIND_CLOG && kind <= KIND_UNCLOG_NODE) {
      const bool on = kind == KIND_CLOG || kind == KIND_CLOG_NODE;
      const bool node_wide = kind == KIND_CLOG_NODE || kind == KIND_UNCLOG_NODE;
      const int32_t ca = a0, cb = node_wide ? -1 : a1;
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
      const Emit& e = em[j];
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
      s.ev_args[cursor][0] = e.a0;
      s.ev_args[cursor][1] = e.a1;
      cursor++;
    }
  }

  // ---- halt, trace, clock ----
  const bool halted =
      s.halted || (dispatch && kind == KIND_HALT) || (has_event && over_limit);
  if (halted && !s.halted) s.halt_time = now < c.time_limit ? now : c.time_limit;
  s.halted = halted;
  if (dispatch) s.trace = trace_fold(s.trace, now, kind, dst, a0, a1);
  s.now = now_after;
  s.step += 1u;
  return has_event;
}

// `r` steps of a halted seed: each consumes its earliest valid slot
// without dispatching it, and advances `step`
template <int E>
MADSIM_HD void raft_drain(RaftSeed<E>& s, int64_t r) {
  int64_t n_valid = 0;
  for (int e = 0; e < E; e++) n_valid += s.ev_valid[e] ? 1 : 0;
  if (r >= n_valid) {
    for (int e = 0; e < E; e++) s.ev_valid[e] = false;
  } else {
    for (int64_t k = 0; k < r; k++) s.ev_valid[raft_first_min(s)] = false;
  }
  s.step += static_cast<uint32_t>(r);
}

// Up to `budget` steps of one seed. With stop_at_halt the seed stops at
// its halt and the return value is the steps it took; without, it takes
// all `budget` steps (a halted seed drains). Either way each iteration
// advances `step` exactly as the plain step would.
template <int E>
MADSIM_HD int64_t raft_run(RaftSeed<E>& s, const RaftConfig& c,
                           const int32_t* init_rows,
                           const uint8_t* volatile_cols, int64_t budget,
                           bool stop_at_halt) {
  int64_t it = 0;
  while (it < budget) {
    if (s.halted) {
      if (stop_at_halt) return it;
      raft_drain(s, budget - it);
      return budget;
    }
    const bool had_event = raft_step(s, c, init_rows, volatile_cols);
    it++;
    if (!had_event && !s.halted) {
      // an empty pool stays empty: the rest only counts steps
      s.step += static_cast<uint32_t>(budget - it);
      return budget;
    }
  }
  return it;
}

template <int E>
MADSIM_HD void raft_run_seed(const RaftArgs& a, int64_t i) {
  const int64_t budget = a.budget[i];
  if (budget <= 0) {
    a.iters[i] = 0;
    return;
  }
  RaftSeed<E> s;
  raft_load(s, a, i);
  a.iters[i] = raft_run(s, a.cfg, a.init_rows, a.volatile_cols, budget,
                        a.stop_at_halt != 0);
  raft_store(s, a, i);
}

}  // namespace madsim
