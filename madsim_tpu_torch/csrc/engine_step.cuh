// One seed of the batched engine on a lane group: step, drain and run
// loop, and a block's load and store of its seeds' state, generic over
// the workload.
//
// This is the body of the fused run kernel (run_kernel.cu), which
// replaces the JAX package's Pallas kernel
// madsim_tpu/engine/vmem.py:make_run_vmem. Every function here is
// MADSIM_HD: __host__ __device__ under nvcc, plain C++ under g++, so
// the same code also builds on a machine without a card and is held
// against the plain torch step there (tests/test_torch_kernel_host.py
// and the per-model tests); lanes.cuh says how a group of G lanes runs
// on the host.
//
// Semantics are those of madsim_tpu_torch/engine/core.py (the port's
// plain step, itself held bit for bit against the JAX engine): pop the
// first minimum of (valid ? time : 2^62); gate on liveness, epoch, clog
// and pause; run one handler or one engine kind; place the emits into
// free slots in pool order; fold the trace; advance the clock by the
// poll cost. Where the plain step evaluates every handler and every
// threefry lane and then selects, this code computes only what the
// selected path reads: a draw is a pure function of (seed, step,
// purpose), so the values are the same.
//
// What bounds it, and the design. A run moves each seed's state in and
// out of device memory once, and per step does an E-wide pool scan and
// a few threefry blocks (chip_smoke.py computes both terms of the bound)
// — integer work on a state of 1.5-7 KB a seed. The state lives in
// shared memory (Seed, below: ev_valid as a bitmask, ev_meta as
// uint32), loaded and stored by the whole block with neighbouring
// threads on neighbouring addresses, 16 bytes a thread where a seed's
// row allows. A seed's G lanes split the pop scan (E/G slots each and a
// shuffle reduction), the emit rows (one latency draw and one placement
// each, the j-th surviving emit into the j-th free slot by ballot and
// popcount) and a drain's ranking; the handler and the engine kinds run
// on the group's leader, and every lane computes the step's gates from
// the same shared words, so they cost no divergence. The handler's new
// row and its emit rows are shared memory too.
//
// The workload is a model trait M (model_*.cuh) with
//   static constexpr int N, U, A, W, K, H;  // nodes, row width, args
//                                           // words, payload words,
//                                           // emit slots, handlers
//   static constexpr int R;                 // history record rows per
//                                           // call (0: no recording)
//   struct Params;                          // the factory's runtime words
//   static Params params(const int64_t* words);
//   static void handle(int32_t h, const Ctx<M>&, const Params&,
//                      int32_t* new_row, Emit<A, W>* emits, Rec* recs);
// handle() starts from new_row == the node's row, K zeroed emit rows and
// R cleared record rows (recs is null when R == 0), and fills them in
// the order the torch handler's EmitBuilder calls (the row index keys
// the per-emit latency draw; record rows append in row order).
//
// Operation histories. With R > 0 a seed carries hist_count and
// hist_drop in shared memory (8 bytes), and the handler's record rows
// are the leader's locals. The history rows themselves are write-once
// and nothing reads them back during a run, so they stay in device
// memory: the block copies the input's rows to the output once
// (copy_history) and the leader writes each appended row, 28 bytes,
// straight to the output. The capacity is a runtime word, so one
// library serves every capacity. With R == 0 every history line
// compiles away.
//
// Fault plans. A compiled plan's rows ride in the pool as engine
// events, so the step dispatches the extended chaos kinds beside the
// engine kinds: the one-way clog, the slow-link multiplier (an
// overwrite of every selected cell of `slow`), the duplication flag and
// a node's clock skew, which its handlers see in `now`; the disk-fault
// kinds 251-254 open and close a node's storage windows (below). `slow`,
// `skew` and `dup` live in the seed's shared state and are stored back
// on every run. A library built with duplication rows (DupRows<M>::n ==
// K, written by the unit engine/fused.py makes for it) has K shadow
// emit rows after the restart row: row K + 1 + j repeats user row j
// when that row is a send and the seed's `dup` flag is set, with its own
// latency and loss draw at PURPOSE_DUP + j, which comes before the user
// purposes. A shadow row is the user row read again, so the seed's
// emit rows stay K + 1; its draw words grow to 2K + 1.
//
// Storage faults. A model with SYNC = true (Workload.durable_sync) keeps
// the two-phase sync discipline over its durable columns (the zeros of
// the volatile-column table): each node's disk image, the columns of
// its last uncommitted durable write and its three window flags live in
// the seed's shared state (SeedStorage). A user dispatch replaces the
// node's write mask with the durable columns its handler changed (read
// before the new row is copied over the old) and, when the handler
// called ctx.sync() and the node's disk neither lies nor fails, commits
// them to the image. A KILL reverts the node's durable columns to the
// image, or under an armed torn mode keeps the first keep_cnt = torn
// word mod (dirty + 1) dirty columns in column order, the torn word the
// first of the PURPOSE_TORN block, drawn only for such a kill; the
// volatile reset stays at RESTART. Kinds 251-254 set and clear the
// flags of one node or of every node (args[0] = -1); the handler sees
// its node's EIO flag as ctx.sync_err. Without SYNC every storage line
// compiles away.
//
// Fleet metrics. A run kernel instantiated with MET = true (the state's
// met column is N_METRICS wide) keeps the seed's MET_* counters in
// shared memory: the per-emit counts are reduced over the lane group by
// ballots in place_emits, the rest are the leader's, and the halt code
// records how the seed stopped (HALT_IDLE on the step that finds its
// pool empty). Nothing in them feeds back into the trajectory.
//
// Coverage and the timeline ring. A run kernel instantiated with OBS =
// true carries the observability taps, at runtime widths (engine config
// words 9-11, from the state's columns): cov_words CW, hit counts on or
// off, and the ring's capacity T; with OBS = false every tap line
// compiles away. Each
// seed's observability state sits behind its Seed in shared memory, a
// tail sized at launch (SeedObs): with the ring, the pool rows' emit
// times (ev_emit, written where placement fills a slot) and the ring's
// two counters; with coverage, the CW-word bitmap, each node's last user
// kind and, with hit counts, a saturating byte per bit position. The
// leader folds a dispatch's features in the reference's order (the
// kind transition or the engine kind by time phase, the message edge,
// the user kind by phase, each history record, the model's own features
// of a CovOf<M> trait, then the node's last kind), so a second tap on a
// bit position sees the first one's count. The ring's rows go straight
// to the seed's rows of the output, as history records do, after the
// block has copied the input's rows there. With every width 0 the tail
// is empty.
//
// Tail latency. A model with L = LatOf<M>::n > 0 latency-marker rows a
// call (its trait's L, Workload.lat_markers; 1 for the army variants)
// marks client ops' invokes and responses through Ctx::lat_start and
// lat_end. The tap's widths are runtime words (engine config words
// 12-14): the op columns C (0: the tap off), the measurement windows P
// and the window width. Its columns stay in device memory: a seed's op
// clocks and sketch take 16 C + 256 P bytes, and only a dispatch that
// carries a marker touches them, so the block copies the input's rows
// to the output (copy_latency) and the leader folds each user
// dispatch's markers, in order, straight into the seed's output rows
// (lat_fold): the first start wins, the first response wins, an end
// without a start is ignored and an out-of-range op id counts only in
// lat_drop. A completed op adds one to the (window of its invoke,
// ladder bucket of its latency) cell and, with the coverage taps, that
// pair is a feature under tag 5, after the record taps. With L == 0
// every latency line compiles away.
//
// Causal provenance. The OBS instantiation also carries the causal axis,
// a runtime word (engine config word 15), so the OBS = false kernels do
// not change. With it on, the seed's tail holds each node's Lamport
// clock (lam) and each pool row's emitting dispatch seq and folded clock
// (ev_parent, ev_lam), read at the pop before placement can reuse the
// slot, as ev_emit is. A dispatch's seq is min(step, 2^31 - 1); a
// dispatch to a node in range folds lam[dst] = max(lam[dst], the popped
// row's clock) + 1 in uint32; every row placement fills takes the
// dispatch's seq and folded clock, ring or no ring (a clog reschedule
// keeps its row's). The ring banks the dispatch's seq, its parent's seq
// and the folded clock beside the other columns, and with coverage each
// dispatch, engine kinds too, taps the (depth, jump) feature under tag 7
// right after the kind-by-phase tap. Nothing here feeds back into the
// trajectory.
//
// Client retries. A model with latency markers (L > 0) also carries the
// client-retry timers of a RetrySpec, switched on by a runtime word (the
// policy's op count, engine config word 16; its fields and its two
// backoff tables follow) and compiled out of every L == 0 kernel. An
// army row, a user dispatch of the policy's kind at its node whose token
// names one of its ops, is suppressed when its op already has its
// response (rt_done, read before this dispatch's markers) or when it
// carries the give-up attempt: it still folds the trace, the clock, the
// Lamport clock, the ring and the tag-7 tap, but its handler does not
// run, so it writes no state, emits, records, marks or syncs and taps
// no user feature. A delivered army row arms one re-send: a timer row
// placed after every emit row that has a draw (Seed::KT), the next
// attempt's token at timeout + backoff + jitter, the jitter a
// PURPOSE_RETRY draw taken only for such a row. A user dispatch's
// lat_end markers set rt_done. The three per-op columns stay in device
// memory, in the seed's rows of the output, which the block copies from
// the input once (copy_retry), as the latency columns are; the leader
// touches them once per army dispatch.
#pragma once

#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "lanes.cuh"
#include "threefry.cuh"

namespace madsim {

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
constexpr int32_t KIND_SLOW_LINK = 244;
constexpr int32_t KIND_UNSLOW = 245;
constexpr int32_t KIND_DUP_ON = 246;
constexpr int32_t KIND_DUP_OFF = 247;
constexpr int32_t KIND_SKEW = 248;
constexpr int32_t KIND_CLOG_1W = 249;
constexpr int32_t KIND_UNCLOG_1W = 250;
constexpr int32_t KIND_SYNC_LOSS = 251;
constexpr int32_t KIND_SYNC_OK = 252;
constexpr int32_t KIND_TORN_ON = 253;
constexpr int32_t KIND_TORN_OFF = 254;

// the fleet-metric slots (engine/core.py MET_*) and halt codes
constexpr int N_METRICS = 18;
constexpr int MET_SENT = 0, MET_DELIVERED = 1, MET_LOST = 2, MET_DEAD_DROP = 3,
              MET_DUP = 4, MET_CRASH = 5, MET_RESTART = 6, MET_PAUSE = 7,
              MET_CLOG_BLOCK = 8, MET_TIMER = 9, MET_RECORD = 10, MET_RNG = 11,
              MET_HALT_CODE = 12, MET_SYNC = 13, MET_SYNC_LOST = 14, MET_TORN = 15,
              MET_RETRY = 16, MET_RETRY_GIVEUP = 17;
constexpr int32_t HALT_RUNNING = 0, HALT_DONE = 1, HALT_TIME_LIMIT = 2, HALT_IDLE = 3;

constexpr uint32_t PURPOSE_POLL_COST = 0;
constexpr uint32_t PURPOSE_TORN = 2;
constexpr uint32_t PURPOSE_RETRY = 3;
constexpr uint32_t PURPOSE_LATENCY = 8;
constexpr uint32_t PURPOSE_DUP = 64;
constexpr uint32_t PURPOSE_USER = 128;

// ev_parent of a row no dispatch emitted (engine/core.py PARENT_NONE)
constexpr int32_t PARENT_NONE = -1;
// a dispatch's seq is min(step, kSeqMax), an int32
constexpr uint32_t kSeqMax = 0x7FFFFFFFu;

// the history record convention (check/history.py)
constexpr int32_t OK_PENDING = -1, OK_FAIL = 0, OK_OK = 1;
constexpr int32_t OP_WRITE = 1, OP_READ = 2, OP_USER = 16;

constexpr uint64_t kTracePrime = 0x100000001B3ull;
constexpr uint64_t kTraceMix = 0x9E3779B97F4A7C15ull;

// client-retry op tokens (engine/core.py retry_token): the attempt id in
// bits 26..29 of args[0], the op id below
constexpr int32_t kRetryShift = 26;
constexpr int32_t kRetryAttemptMax = 15;
constexpr int32_t kRetryOpMask = (int32_t(1) << kRetryShift) - 1;

// the engine's words in front of the model's in the config array: the
// config's nine, the run's three observability widths, the latency
// tap's three, the causal axis, then the retry policy's six words and
// its two tables of kRetryAttemptMax + 1 entries
constexpr int kRetryWord = 16;
constexpr int kEngineWords = kRetryWord + 6 + 2 * (kRetryAttemptMax + 1);

// the latency ladder (engine/core.py LAT_EDGES_NS): bucket b of a
// latency d is the count of these edges at or below d, 0..63
constexpr int kLatBuckets = 64;
#define MADSIM_LAT_EDGES \
    65536ll, 77936ll, 92682ll, 110218ll, 131072ll, 155872ll, 185364ll, \
    220436ll, 262144ll, 311744ll, 370728ll, 440872ll, 524288ll, 623487ll, \
    741455ll, 881744ll, 1048576ll, 1246974ll, 1482910ll, 1763488ll, 2097152ll, \
    2493948ll, 2965821ll, 3526975ll, 4194304ll, 4987896ll, 5931642ll, \
    7053950ll, 8388608ll, 9975792ll, 11863283ll, 14107901ll, 16777216ll, \
    19951585ll, 23726566ll, 28215802ll, 33554432ll, 39903169ll, 47453133ll, \
    56431603ll, 67108864ll, 79806339ll, 94906266ll, 112863206ll, 134217728ll, \
    159612677ll, 189812531ll, 225726413ll, 268435456ll, 319225354ll, \
    379625062ll, 451452825ll, 536870912ll, 638450708ll, 759250125ll, \
    902905651ll, 1073741824ll, 1276901417ll, 1518500250ll, 1805811301ll, \
    2147483648ll, 2553802834ll, 3037000500ll

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
  int32_t hist_cap;  // HistorySpec.capacity (0: no recording)
  int32_t cov_words;  // coverage bitmap words (0: no coverage taps)
  bool cov_hitcount;  // the hit counters (needs cov_words > 0)
  int32_t tl_cap;     // timeline ring rows (0: no ring)
  int32_t lat_c;      // latency op columns (0: the tap off)
  int32_t lat_p;      // latency measurement windows
  int64_t lat_phase_ns;  // their width
  bool causal;           // the causal columns (OBS kernels only)
};

// A RetrySpec resolved on the host (engine/fused.py retry_words): n_ops
// == 0 switches the timers off. boff[a] is the backoff before delivering
// attempt a, bjit[a] the largest jitter addend (both at most 2^31 - 1, so
// bjit * a uint32 draw fits an int64), zero past max_attempts.
struct RetryCfg {
  int32_t n_ops, kind, node, op_base, max_attempts;
  int64_t timeout_ns;
  int64_t boff[kRetryAttemptMax + 1];
  int64_t bjit[kRetryAttemptMax + 1];
};

inline RetryCfg retry_config(const int64_t* c) {
  RetryCfg r;
  r.n_ops = static_cast<int32_t>(c[0]);
  r.kind = static_cast<int32_t>(c[1]);
  r.node = static_cast<int32_t>(c[2]);
  r.op_base = static_cast<int32_t>(c[3]);
  r.max_attempts = static_cast<int32_t>(c[4]);
  r.timeout_ns = c[5];
  for (int a = 0; a <= kRetryAttemptMax; a++) {
    r.boff[a] = c[6 + a];
    r.bjit[a] = c[6 + kRetryAttemptMax + 1 + a];
  }
  return r;
}

// uint32 span of a [lo, hi) draw, as Draw._reduce: 0 draws from span 1
MADSIM_HDI uint32_t draw_span(int64_t lo, int64_t hi) {
  const uint32_t s = static_cast<uint32_t>(hi - lo);
  return s == 0 ? 1u : s;
}

// c: lat_min, lat_max, loss_u32, proc_min, proc_max, backoff_min,
//    backoff_max, time_limit_ns (0 = none), history capacity, then the
//    coverage words, the hit-count flag and the ring capacity, then the
//    latency ops, windows and window width, then the causal flag
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
  e.hist_cap = static_cast<int32_t>(c[8]);
  e.cov_words = static_cast<int32_t>(c[9]);
  e.cov_hitcount = c[10] != 0;
  e.tl_cap = static_cast<int32_t>(c[11]);
  e.lat_c = static_cast<int32_t>(c[12]);
  e.lat_p = static_cast<int32_t>(c[13]);
  e.lat_phase_ns = c[14] > 0 ? c[14] : 1;
  e.causal = c[15] != 0;
  return e;
}
// One pointer per SimState field the kernel touches (the port's torch
// layout: seed-major, contiguous), in engine/fused.py KERNEL_FIELDS
// order. The output side has no seed (the kernel never writes it),
// ev_pay only when W > 0, the history columns only when R > 0, the
// storage columns only for a SYNC model, met only with metrics, the
// coverage columns only with coverage, the ring's (with ev_emit) only
// with a ring, the latency columns only with the tap on a model with
// markers, the causal columns only with the axis on and the retry
// columns only with a policy on a model with markers.
struct Fields {
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
  int32_t* ev_pay;     // (S,E,W)
  uint8_t* alive;      // (S,N)
  uint8_t* paused;     // (S,N)
  int32_t* epoch;      // (S,N)
  int32_t* node_state; // (S,N,U)
  uint8_t* clog;       // (S,N,N)
  int32_t* slow;       // (S,N,N)
  int32_t* skew;       // (S,N)
  uint8_t* dup;        // (S,)
  int32_t* hist_count; // (S,)
  int32_t* hist_drop;  // (S,)
  int32_t* hist_word;  // (S,Hc,5) [op, key, arg, client, ok]
  int64_t* hist_t;     // (S,Hc)
  int32_t* disk;       // (S,N,U) the synced durable image (SYNC)
  uint8_t* wmask;      // (S,N,U) the last uncommitted write's columns
  uint8_t* sync_loss;  // (S,N)
  uint8_t* sync_eio;   // (S,N)
  uint8_t* torn;       // (S,N)
  int32_t* met;        // (S,N_METRICS) with metrics
  int64_t* cov;        // (S,CW) uint32 values
  int32_t* cov_last;   // (S,N) with coverage
  uint8_t* cov_hits;   // (S,CW*32) with hit counts
  int32_t* tl_count;   // (S,)
  int32_t* tl_drop;    // (S,)
  int64_t* tl_t;       // (S,T)
  int64_t* tl_meta;    // (S,T) uint32 values
  int32_t* tl_args;    // (S,T,A)
  int32_t* tl_pay;     // (S,T,W)
  int64_t* tl_emit;    // (S,T)
  int64_t* ev_emit;    // (S,E) with a ring
  int64_t* lat_inv;    // (S,C) each op's invoke clock, -1 = not yet
  int64_t* lat_resp;   // (S,C) its response clock, -1 = not yet
  int32_t* lat_hist;   // (S,P,64) the ladder sketch
  int32_t* lat_count;  // (S,)
  int32_t* lat_drop;   // (S,)
  int64_t* lam;        // (S,N) uint32 values: each node's Lamport clock
  int32_t* ev_parent;  // (S,E) each pool row's emitting dispatch seq
  int64_t* ev_lam;     // (S,E) uint32 values: that dispatch's clock
  int32_t* tl_seq;     // (S,T) the captured dispatch's seq
  int32_t* tl_parent;  // (S,T) its parent's seq
  int64_t* tl_lam;     // (S,T) uint32 values: its folded clock
  uint8_t* rt_done;    // (S,CR) each op's response seen
  int32_t* rt_attempt; // (S,CR) its last delivered attempt
  int64_t* rt_deadline;  // (S,CR) its armed deadline
};

constexpr int kFieldPointers = 57;

inline Fields fields(void* const* p) {
  Fields f;
  f.seed = static_cast<int64_t*>(p[0]);
  f.now = static_cast<int64_t*>(p[1]);
  f.step = static_cast<int64_t*>(p[2]);
  f.halted = static_cast<uint8_t*>(p[3]);
  f.halt_time = static_cast<int64_t*>(p[4]);
  f.trace = static_cast<int64_t*>(p[5]);
  f.overflow = static_cast<int32_t*>(p[6]);
  f.msg_count = static_cast<int64_t*>(p[7]);
  f.ev_time = static_cast<int64_t*>(p[8]);
  f.ev_valid = static_cast<uint8_t*>(p[9]);
  f.ev_meta = static_cast<int64_t*>(p[10]);
  f.ev_epoch = static_cast<int32_t*>(p[11]);
  f.ev_args = static_cast<int32_t*>(p[12]);
  f.ev_pay = static_cast<int32_t*>(p[13]);
  f.alive = static_cast<uint8_t*>(p[14]);
  f.paused = static_cast<uint8_t*>(p[15]);
  f.epoch = static_cast<int32_t*>(p[16]);
  f.node_state = static_cast<int32_t*>(p[17]);
  f.clog = static_cast<uint8_t*>(p[18]);
  f.slow = static_cast<int32_t*>(p[19]);
  f.skew = static_cast<int32_t*>(p[20]);
  f.dup = static_cast<uint8_t*>(p[21]);
  f.hist_count = static_cast<int32_t*>(p[22]);
  f.hist_drop = static_cast<int32_t*>(p[23]);
  f.hist_word = static_cast<int32_t*>(p[24]);
  f.hist_t = static_cast<int64_t*>(p[25]);
  f.disk = static_cast<int32_t*>(p[26]);
  f.wmask = static_cast<uint8_t*>(p[27]);
  f.sync_loss = static_cast<uint8_t*>(p[28]);
  f.sync_eio = static_cast<uint8_t*>(p[29]);
  f.torn = static_cast<uint8_t*>(p[30]);
  f.met = static_cast<int32_t*>(p[31]);
  f.cov = static_cast<int64_t*>(p[32]);
  f.cov_last = static_cast<int32_t*>(p[33]);
  f.cov_hits = static_cast<uint8_t*>(p[34]);
  f.tl_count = static_cast<int32_t*>(p[35]);
  f.tl_drop = static_cast<int32_t*>(p[36]);
  f.tl_t = static_cast<int64_t*>(p[37]);
  f.tl_meta = static_cast<int64_t*>(p[38]);
  f.tl_args = static_cast<int32_t*>(p[39]);
  f.tl_pay = static_cast<int32_t*>(p[40]);
  f.tl_emit = static_cast<int64_t*>(p[41]);
  f.ev_emit = static_cast<int64_t*>(p[42]);
  f.lat_inv = static_cast<int64_t*>(p[43]);
  f.lat_resp = static_cast<int64_t*>(p[44]);
  f.lat_hist = static_cast<int32_t*>(p[45]);
  f.lat_count = static_cast<int32_t*>(p[46]);
  f.lat_drop = static_cast<int32_t*>(p[47]);
  f.lam = static_cast<int64_t*>(p[48]);
  f.ev_parent = static_cast<int32_t*>(p[49]);
  f.ev_lam = static_cast<int64_t*>(p[50]);
  f.tl_seq = static_cast<int32_t*>(p[51]);
  f.tl_parent = static_cast<int32_t*>(p[52]);
  f.tl_lam = static_cast<int64_t*>(p[53]);
  f.rt_done = static_cast<uint8_t*>(p[54]);
  f.rt_attempt = static_cast<int32_t*>(p[55]);
  f.rt_deadline = static_cast<int64_t*>(p[56]);
  return f;
}

// One launch of the run kernel: the input state (read only), the fresh
// output state (written only), the restart tables, each seed's
// iteration count and their maximum (tmax, may be null), and the step
// budget every seed gets.
struct RunArgs {
  Fields in, out;
  const int32_t* init_rows;      // (N,U)
  const uint8_t* volatile_cols;  // (U,)
  int64_t* iters;                // (S,) steps taken before a halt stopped it
  int64_t* tmax;                 // (1,) max of iters
  int64_t n_seeds;
  int64_t budget;
  int32_t stop_at_halt;  // 1: a seed stops at its halt; 0: it drains
  EngineConfig cfg;
  RetryCfg rt;  // read only by the kernels of a model with markers
};

constexpr int kRunPointers = 2 * kFieldPointers + 4;

// p: the input fields, the output fields, the two tables, iters and
// tmax (engine/fused.py kernel_args); c: the engine's config words
inline RunArgs run_args(void* const* p, const int64_t* c, int64_t n_seeds,
                        int64_t budget, int32_t stop_at_halt) {
  RunArgs a;
  a.in = fields(p);
  a.out = fields(p + kFieldPointers);
  a.init_rows = static_cast<const int32_t*>(p[2 * kFieldPointers]);
  a.volatile_cols = static_cast<const uint8_t*>(p[2 * kFieldPointers + 1]);
  a.iters = static_cast<int64_t*>(p[2 * kFieldPointers + 2]);
  a.tmax = static_cast<int64_t*>(p[2 * kFieldPointers + 3]);
  a.n_seeds = n_seeds;
  a.budget = budget;
  a.stop_at_halt = stop_at_halt;
  a.cfg = engine_config(c);
  a.rt = retry_config(c + kRetryWord);
  return a;
}

// One launch of the drain kernel, in place on a run's output: each
// seed takes its remaining tmax - iters halted steps.
struct DrainArgs {
  int64_t* step;           // (S,)
  uint8_t* ev_valid;       // (S,E)
  const int64_t* ev_time;  // (S,E)
  const int64_t* iters;    // (S,)
  const int64_t* tmax;     // (1,)
  int64_t n_seeds;
};

constexpr int kDrainPointers = 5;

inline DrainArgs drain_args(void* const* p, int64_t n_seeds) {
  DrainArgs d;
  d.step = static_cast<int64_t*>(p[0]);
  d.ev_valid = static_cast<uint8_t*>(p[1]);
  d.ev_time = static_cast<const int64_t*>(p[2]);
  d.iters = static_cast<const int64_t*>(p[3]);
  d.tmax = static_cast<const int64_t*>(p[4]);
  d.n_seeds = n_seeds;
  return d;
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

// one history record row (the port's Emits.rec_valid and rec, one seed):
// EmitBuilder.record(op, key, arg, ok, when)
struct Rec {
  bool valid;
  int32_t op, key, arg, ok;

  MADSIM_HDI void clear() {
    valid = false;
    op = key = arg = ok = 0;
  }
  MADSIM_HDI void record(bool when, int32_t o, int32_t k, int32_t a, int32_t r) {
    valid = when;
    op = o;
    key = k;
    arg = a;
    ok = r;
  }
};

// one latency-marker row (the port's Emits.lat_valid and lat, one seed):
// EmitBuilder.lat_start (phase 0) and lat_end (phase 1)
struct Lat {
  bool valid;
  int32_t op, phase;
};

// A model's latency-marker rows a call: its trait's L, 0 where it
// declares none (every latency line then compiles away).
template <class M, class = void>
struct LatOf {
  static constexpr int n = 0;
};
template <class M>
struct LatOf<M, std::void_t<decltype(M::L)>> {
  static constexpr int n = M::L;
};

// where a seed's latency columns are: its rows of the output, and the
// tap's widths (c == 0: off); nothing when the model has no markers
template <int L>
struct LatOut {
  int64_t* inv;   // (C,)
  int64_t* resp;  // (C,)
  int32_t* hist;  // (P, 64)
  int32_t* count;
  int32_t* drop;
  int32_t c, p;
  int64_t phase_ns;
};
template <>
struct LatOut<0> {};

// where a seed's retry books are: its rows of the output, and the run's
// policy (n_ops == 0: off); nothing when the model has no markers
template <int L>
struct RetryOut {
  uint8_t* done;      // (CR,)
  int32_t* attempt;   // (CR,)
  int64_t* deadline;  // (CR,)
  const RetryCfg* cfg;
};
template <>
struct RetryOut<0> {};

// the ladder bucket of a latency: the count of edges at or below it
MADSIM_HDI int32_t lat_bucket(int64_t d) {
  const int64_t edges[kLatBuckets - 1] = {MADSIM_LAT_EDGES};
  int32_t b = 0;
  for (int k = 0; k < kLatBuckets - 1; k++) b += d >= edges[k];
  return b;
}

// Fold a user dispatch's L marker rows into the seed's latency columns,
// in order, each seeing the last one's writes; `now` is the dispatch
// clock without the node's skew. feat[j] and on[j] are row j's coverage
// feature (window, bucket, tag 5) and whether it completed an op. The
// leader's work.
template <int L>
MADSIM_HDI void lat_fold(const LatOut<L>& lo, const Lat* m, int64_t now, uint32_t* feat,
                         bool* on) {
  for (int j = 0; j < L; j++) {
    on[j] = false;
    if (!m[j].valid) continue;
    const int32_t oid = m[j].op;
    if (oid < 0 || oid >= lo.c) {
      *lo.drop += 1;
      continue;
    }
    const int64_t inv = lo.inv[oid];
    if (m[j].phase != 1) {  // a start: the first one wins
      if (inv < 0) lo.inv[oid] = now;
      continue;
    }
    // a response: needs a start, and the first one wins
    if (inv < 0 || lo.resp[oid] >= 0) continue;
    lo.resp[oid] = now;
    const int32_t bkt = lat_bucket(now - inv);
    // the invoke's window, cast to int32 before the clip as the
    // reference does (inv >= 0 here, so / is floor division)
    const int32_t ph = clampi(static_cast<int32_t>(inv / lo.phase_ns), 0, lo.p - 1);
    lo.hist[ph * kLatBuckets + bkt] += 1;
    *lo.count += 1;
    feat[j] = static_cast<uint32_t>(bkt) | (static_cast<uint32_t>(ph) << 8) | (5u << 24);
    on[j] = true;
  }
}

// the history counters of a seed in shared memory, present only when
// the model records (an empty base takes no bytes)
template <int R>
struct SeedHistory {
  int32_t hist_count;
  int32_t hist_drop;
};
template <>
struct SeedHistory<0> {};

// Whether a model keeps the sync discipline: its trait's SYNC, false
// where it declares none.
template <class M, class = void>
struct SyncOf : std::false_type {};
template <class M>
struct SyncOf<M, std::void_t<decltype(M::SYNC)>> : std::bool_constant<M::SYNC> {};

// the storage state of a seed's N nodes, present only for a SYNC model
template <int N, int U, bool ON>
struct SeedStorage {
  int32_t disk[N * U];
  bool wmask[N * U];
  bool sync_loss[N];
  bool sync_eio[N];
  bool torn[N];
};
template <int N, int U>
struct SeedStorage<N, U, false> {};

// the fleet counters of a seed, present only with metrics
template <bool MET>
struct SeedMetrics {
  int32_t met[N_METRICS];
};
template <>
struct SeedMetrics<false> {};

// where a seed's appended history rows go: its rows of the output
template <int R>
struct HistOut {
  int32_t* word;  // (cap, 5)
  int64_t* t;     // (cap,)
  int32_t cap;
};
template <>
struct HistOut<0> {};

// A model's own coverage features (Workload.cov_features): a trait with
//   static constexpr int NCOV;  // features a dispatch (0: none)
//   static void cov_features(const int32_t* node_state, uint32_t* feats);
// reads the fleet's state after a user dispatch; the engine hashes each
// feature's low 24 bits under tag 6. CovOf<M>::n is 0 for a model
// without the trait.
template <class M, class = void>
struct CovOf {
  static constexpr int n = 0;
};
template <class M>
struct CovOf<M, std::void_t<decltype(M::NCOV)>> {
  static constexpr int n = M::NCOV;
};

// One seed's observability state: pointers into its shared tail (null
// where the tap is off) and to its rows of the output ring.
struct SeedObs {
  int64_t* ev_emit;   // (E,) each pool row's emit clock
  int32_t* tl;        // [tl_count, tl_drop]
  uint32_t* cov;      // (CW,) the bitmap
  int32_t* cov_last;  // (N,) each node's last user kind
  uint8_t* hits;      // (CW*32,) the hit counters
  int64_t* ring_t;
  int64_t* ring_meta;
  int32_t* ring_args;
  int32_t* ring_pay;
  int64_t* ring_emit;
  uint32_t* lam;       // (N,) each node's Lamport clock, with the causal axis
  int32_t* ev_parent;  // (E,) each pool row's emitting dispatch seq
  uint32_t* ev_lam;    // (E,) that dispatch's folded clock
  int32_t* ring_seq;
  int32_t* ring_parent;
  int64_t* ring_lam;
  int32_t cw, tl_cap;
  bool hc, causal;
};

// where the pieces of the tail start, in bytes (-1: absent), and its
// size, a multiple of 16 (0 when every tap is off)
struct ObsLayout {
  int32_t ev_emit, tl, ev_parent, ev_lam, lam, cov, cov_last, hits, bytes;
};

template <int N, int E>
MADSIM_HDI ObsLayout obs_layout(const EngineConfig& c) {
  ObsLayout l{-1, -1, -1, -1, -1, -1, -1, -1, 0};
  int32_t b = 0;
  if (c.tl_cap > 0) {
    l.ev_emit = b;
    b += E * 8;
    l.tl = b;
    b += 8;
  }
  if (c.causal) {
    l.ev_parent = b;
    b += E * 4;
    l.ev_lam = b;
    b += E * 4;
    l.lam = b;
    b += N * 4;
  }
  if (c.cov_words > 0) {
    l.cov = b;
    b += c.cov_words * 4;
    l.cov_last = b;
    b += N * 4;
    if (c.cov_hitcount) {
      l.hits = b;
      b += c.cov_words * 32;
    }
  }
  l.bytes = (b + 15) / 16 * 16;
  return l;
}

// A block's seeds in shared memory (or one seed's on the host): with
// OBS, seed b's Seed at base + b * stride and its observability tail
// `head` bytes into its slot; without, a plain array of Seed.
template <class S, bool OBS>
struct SeedBlock {
  unsigned char* base;
  size_t stride, head;
  ObsLayout lay;
  EngineConfig cfg;

  MADSIM_HDI S& operator[](int b) const {
    if constexpr (OBS) {
      return *reinterpret_cast<S*>(base + static_cast<size_t>(b) * stride);
    } else {
      return reinterpret_cast<S*>(base)[b];
    }
  }
  template <class T>
  MADSIM_HDI T* at(int b, int32_t off) const {
    return off < 0 ? nullptr
                   : reinterpret_cast<T*>(base + static_cast<size_t>(b) * stride + head + off);
  }
  MADSIM_HDI SeedObs obs(int b) const {
    SeedObs o{};
    o.ev_emit = at<int64_t>(b, lay.ev_emit);
    o.tl = at<int32_t>(b, lay.tl);
    o.cov = at<uint32_t>(b, lay.cov);
    o.cov_last = at<int32_t>(b, lay.cov_last);
    o.hits = at<uint8_t>(b, lay.hits);
    o.ev_parent = at<int32_t>(b, lay.ev_parent);
    o.ev_lam = at<uint32_t>(b, lay.ev_lam);
    o.lam = at<uint32_t>(b, lay.lam);
    o.cw = cfg.cov_words;
    o.tl_cap = cfg.tl_cap;
    o.hc = cfg.cov_hitcount;
    o.causal = cfg.causal;
    return o;
  }
};

// bytes a seed takes in shared memory under the run's taps
template <class S, int N, int E>
MADSIM_HDI size_t seed_stride(const EngineConfig& c) {
  const int32_t ob = obs_layout<N, E>(c).bytes;
  return ob ? (sizeof(S) + 15) / 16 * 16 + ob : sizeof(S);
}

template <class S, int N, int E, bool OBS>
MADSIM_HDI SeedBlock<S, OBS> seed_block(unsigned char* base, const EngineConfig& c) {
  SeedBlock<S, OBS> blk{};
  blk.base = base;
  if constexpr (OBS) {
    blk.stride = seed_stride<S, N, E>(c);
    blk.head = (sizeof(S) + 15) / 16 * 16;
    blk.lay = obs_layout<N, E>(c);
    blk.cfg = c;
  }
  return blk;
}

// The user draw purposes a model declares (Workload.draw_purposes). A
// seed's lanes draw them at the start of every step, beside the emit
// rows' latency draws, so the handler reads them from shared memory
// instead of waiting on a threefry block. The unit engine/fused.py
// writes specializes this for its model; a purpose it does not list is
// drawn where the handler asks for it.
template <class M>
struct UserDraws {
  static constexpr int n = 0;
  static MADSIM_HDI uint32_t purpose(int) { return 0; }
};

// The duplication shadow rows of a library (make_step(dup_rows=True)):
// n = 0 here, and K in the unit engine/fused.py writes for a library
// built with them.
template <class M>
struct DupRows {
  static constexpr int n = 0;
};

// What a handler sees (the port's HandlerCtx, one seed), with the
// counter-based draws of engine/rng.py Draw. sync() is the port's
// EmitBuilder.sync: the dispatch's fsync flag, the OR of its calls.
template <class M>
struct Ctx {
  const int32_t* state;  // (U,) the node's row
  int32_t node, src;
  const int32_t* args;   // (A,)
  const int32_t* pay;    // (W,)
  int64_t now;           // the clock plus the node's skew
  uint32_t k0, k1, step;
  const uint32_t* drawn;  // (UserDraws<M>::n,) this step's declared draws
  bool sync_err;          // the node's fsync-EIO flag before the dispatch
  bool* sync_flag;        // the dispatch's fsync
  Lat* lats;              // (LatOf<M>::n,) the dispatch's latency markers
  int32_t* n_lat;         // the markers made so far

  MADSIM_HDI void sync(bool when) const {
    if (when) *sync_flag = true;
  }
  // EmitBuilder.lat_start and lat_end: the next marker row, in call order
  MADSIM_HDI void lat_start(bool when, int32_t op) const { lat_mark(when, op, 0); }
  MADSIM_HDI void lat_end(bool when, int32_t op) const { lat_mark(when, op, 1); }
  MADSIM_HDI void lat_mark(bool when, int32_t op, int32_t phase) const {
    Lat& m = lats[(*n_lat)++];
    m.valid = when;
    m.op = op;
    m.phase = phase;
  }

  MADSIM_HDI uint32_t user(uint32_t purpose) const {
    for (int d = 0; d < UserDraws<M>::n; d++)
      if (UserDraws<M>::purpose(d) == purpose) return drawn[d];
    uint32_t b0, b1;
    threefry2x32(k0, k1, step, PURPOSE_USER + purpose, &b0, &b1);
    return b0;
  }
  MADSIM_HDI int64_t user_int(int64_t lo, int64_t hi, uint32_t purpose) const {
    return lo + static_cast<int64_t>(user(purpose) % draw_span(lo, hi));
  }
};


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


// One seed's state for the whole run, in the block's shared memory
// (a plain struct on the host): the pool's valid flags as a bitmask, the
// event meta words as uint32, the handler's new row and emit rows, with
// R > 0 the history counters, for a SYNC model the storage state and
// with MET the counters.
template <class M, int E, bool MET = false>
struct Seed : SeedHistory<M::R>, SeedStorage<M::N, M::U, SyncOf<M>::value>, SeedMetrics<MET> {
  static constexpr int N = M::N, U = M::U, A = M::A, W = M::W, K = M::K;
  // emit rows with a draw: the user rows, the restart row, the shadows
  static constexpr int KT = K + 1 + DupRows<M>::n;
  // the re-send row a model with markers may place after them (no draw)
  static constexpr int RT = LatOf<M>::n > 0 ? 1 : 0;
  int64_t ev_time[E];
  uint64_t seed;
  int64_t now;
  int64_t halt_time;
  uint64_t trace;
  int64_t msg_count;
  Emit<A, W> em[K + 1 + RT];
  uint32_t ev_meta[E];
  int32_t ev_epoch[E];
  int32_t ev_args[E * A];
  int32_t ev_pay[W > 0 ? E * W : 1];
  uint32_t ev_bits[PoolBits<E>::NW];
  int32_t epoch[N];
  int32_t skew[N];
  int32_t node_state[N * U];
  int32_t slow[N * N];
  int32_t new_row[U];
  // this step's draws: the emit rows' latency blocks (the shadow rows'
  // too) and the declared user purposes' first words
  uint32_t lat0[KT];
  uint32_t lat1[KT];
  uint32_t user0[UserDraws<M>::n > 0 ? UserDraws<M>::n : 1];
  uint32_t step;
  int32_t overflow;
  bool alive[N];
  bool paused[N];
  bool clog[N * N];
  bool halted;
  bool dup;
};

template <class M, int E, bool MET, bool OBS>
using Block = SeedBlock<Seed<M, E, MET>, OBS>;

template <class M, int E, bool MET, bool OBS>
MADSIM_HDI Block<M, E, MET, OBS> make_block(unsigned char* base, const EngineConfig& c) {
  return seed_block<Seed<M, E, MET>, M::N, E, OBS>(base, c);
}

MADSIM_HDI void block_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

struct alignas(16) Vec16 {
  uint32_t w[4];
};

// The block's slice of a (S, C) field, seeds [first, first + nb): thread
// `tid` of `nt` takes elements tid, tid + nt, ..., so neighbouring
// threads read neighbouring addresses, 16 bytes at a time where a seed's
// row is a whole number of 16-byte words and the slice is aligned.
// put(b, k, v) keeps element k of the block's seed b.
template <int C, class T, class F>
MADSIM_HDI void rows_in(const T* g, int64_t first, int nb, int tid, int nt,
                        F put) {
  if constexpr (C > 0) {
    const T* src = g + first * C;
    const int n = nb * C;
    if constexpr ((C * sizeof(T)) % 16 == 0) {
      constexpr int V = 16 / sizeof(T);
      if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
        const Vec16* v = reinterpret_cast<const Vec16*>(src);
        for (int q = tid; q < n / V; q += nt) {
          const Vec16 w = v[q];
          T e[V];
          memcpy(e, &w, 16);
          for (int k = 0; k < V; k++) put((q * V + k) / C, (q * V + k) % C, e[k]);
        }
        return;
      }
    }
    for (int idx = tid; idx < n; idx += nt) put(idx / C, idx % C, src[idx]);
  }
}

// the same for a store: get(b, k) gives element k of seed b
template <int C, class T, class F>
MADSIM_HDI void rows_out(T* g, int64_t first, int nb, int tid, int nt, F get) {
  if constexpr (C > 0) {
    T* dst = g + first * C;
    const int n = nb * C;
    if constexpr ((C * sizeof(T)) % 16 == 0) {
      constexpr int V = 16 / sizeof(T);
      if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
        Vec16* v = reinterpret_cast<Vec16*>(dst);
        for (int q = tid; q < n / V; q += nt) {
          T e[V];
          for (int k = 0; k < V; k++) e[k] = get((q * V + k) / C, (q * V + k) % C);
          Vec16 w;
          memcpy(&w, e, 16);
          v[q] = w;
        }
        return;
      }
    }
    for (int idx = tid; idx < n; idx += nt) dst[idx] = get(idx / C, idx % C);
  }
}

// rows_in and rows_out for a runtime row width C (the observability
// columns), 16 bytes a thread at a time where the rows allow, as rows_in
template <class T, class F>
MADSIM_HDI void rows_in_n(const T* g, int64_t first, int nb, int32_t C, int tid, int nt,
                          F put) {
  if (C <= 0) return;
  const T* src = g + first * C;
  const int64_t n = static_cast<int64_t>(nb) * C;
  constexpr int V = 16 / sizeof(T);
  if (C % V == 0 && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const Vec16* v = reinterpret_cast<const Vec16*>(src);
    for (int64_t q = tid; q < n / V; q += nt) {
      const Vec16 w = v[q];
      T e[V];
      memcpy(e, &w, 16);
      for (int k = 0; k < V; k++)
        put(static_cast<int>((q * V + k) / C), static_cast<int32_t>((q * V + k) % C), e[k]);
    }
    return;
  }
  for (int64_t idx = tid; idx < n; idx += nt)
    put(static_cast<int>(idx / C), static_cast<int32_t>(idx % C), src[idx]);
}
template <class T, class F>
MADSIM_HDI void rows_out_n(T* g, int64_t first, int nb, int32_t C, int tid, int nt, F get) {
  if (C <= 0) return;
  T* dst = g + first * C;
  const int64_t n = static_cast<int64_t>(nb) * C;
  constexpr int V = 16 / sizeof(T);
  if (C % V == 0 && (reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    Vec16* v = reinterpret_cast<Vec16*>(dst);
    for (int64_t q = tid; q < n / V; q += nt) {
      T e[V];
      for (int k = 0; k < V; k++)
        e[k] = get(static_cast<int>((q * V + k) / C), static_cast<int32_t>((q * V + k) % C));
      Vec16 w;
      memcpy(&w, e, 16);
      v[q] = w;
    }
    return;
  }
  for (int64_t idx = tid; idx < n; idx += nt)
    dst[idx] = get(static_cast<int>(idx / C), static_cast<int32_t>(idx % C));
}

// copy `bytes` bytes, 16 at a time where both ends are aligned (every
// thread of the block, neighbouring threads on neighbouring words)
MADSIM_HDI void copy_bytes(void* dst, const void* src, int64_t bytes, int tid, int nt) {
  auto* d = static_cast<unsigned char*>(dst);
  const auto* s = static_cast<const unsigned char*>(src);
  int64_t done = 0;
  if (((reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s)) & 15u) == 0) {
    Vec16* dv = reinterpret_cast<Vec16*>(d);
    const Vec16* sv = reinterpret_cast<const Vec16*>(s);
    for (int64_t q = tid; q < bytes / 16; q += nt) dv[q] = sv[q];
    done = bytes / 16 * 16;
  }
  for (int64_t x = done + tid; x < bytes; x += nt) d[x] = s[x];
}

// load and store the observability tails of seeds [first, first + nb),
// every thread of the block: the emit times and the ring's counters with
// a ring, the pool's causal sidecars and the clocks with the causal axis,
// the bitmap, the last kinds and the hit counters with coverage
template <class M, int E, class B>
MADSIM_HD void load_obs(const B& blk, const Fields& f, int64_t first, int nb, int tid,
                        int nt) {
  const EngineConfig& c = blk.cfg;
  if (c.tl_cap > 0) {
    rows_in<E>(f.ev_emit, first, nb, tid, nt,
               [&](int b, int k, int64_t v) { blk.obs(b).ev_emit[k] = v; });
    rows_in<1>(f.tl_count, first, nb, tid, nt,
               [&](int b, int, int32_t v) { blk.obs(b).tl[0] = v; });
    rows_in<1>(f.tl_drop, first, nb, tid, nt,
               [&](int b, int, int32_t v) { blk.obs(b).tl[1] = v; });
  }
  if (c.causal) {
    rows_in<E>(f.ev_parent, first, nb, tid, nt,
               [&](int b, int k, int32_t v) { blk.obs(b).ev_parent[k] = v; });
    rows_in<E>(f.ev_lam, first, nb, tid, nt, [&](int b, int k, int64_t v) {
      blk.obs(b).ev_lam[k] = static_cast<uint32_t>(v);
    });
    rows_in<M::N>(f.lam, first, nb, tid, nt, [&](int b, int k, int64_t v) {
      blk.obs(b).lam[k] = static_cast<uint32_t>(v);
    });
  }
  if (c.cov_words > 0) {
    rows_in_n(f.cov, first, nb, c.cov_words, tid, nt, [&](int b, int32_t k, int64_t v) {
      blk.obs(b).cov[k] = static_cast<uint32_t>(v);
    });
    rows_in<M::N>(f.cov_last, first, nb, tid, nt,
                  [&](int b, int k, int32_t v) { blk.obs(b).cov_last[k] = v; });
    if (c.cov_hitcount)
      rows_in_n(f.cov_hits, first, nb, c.cov_words * 32, tid, nt,
                [&](int b, int32_t k, uint8_t v) { blk.obs(b).hits[k] = v; });
  }
}

template <class M, int E, class B>
MADSIM_HD void store_obs(const B& blk, const Fields& f, int64_t first, int nb, int tid,
                         int nt) {
  const EngineConfig& c = blk.cfg;
  if (c.tl_cap > 0) {
    rows_out<E>(f.ev_emit, first, nb, tid, nt, [&](int b, int k) { return blk.obs(b).ev_emit[k]; });
    rows_out<1>(f.tl_count, first, nb, tid, nt, [&](int b, int) { return blk.obs(b).tl[0]; });
    rows_out<1>(f.tl_drop, first, nb, tid, nt, [&](int b, int) { return blk.obs(b).tl[1]; });
  }
  if (c.causal) {
    rows_out<E>(f.ev_parent, first, nb, tid, nt,
                [&](int b, int k) { return blk.obs(b).ev_parent[k]; });
    rows_out<E>(f.ev_lam, first, nb, tid, nt,
                [&](int b, int k) { return static_cast<int64_t>(blk.obs(b).ev_lam[k]); });
    rows_out<M::N>(f.lam, first, nb, tid, nt,
                   [&](int b, int k) { return static_cast<int64_t>(blk.obs(b).lam[k]); });
  }
  if (c.cov_words > 0) {
    rows_out_n(f.cov, first, nb, c.cov_words, tid, nt, [&](int b, int32_t k) {
      return static_cast<int64_t>(blk.obs(b).cov[k]);
    });
    rows_out<M::N>(f.cov_last, first, nb, tid, nt,
                   [&](int b, int k) { return blk.obs(b).cov_last[k]; });
    if (c.cov_hitcount)
      rows_out_n(f.cov_hits, first, nb, c.cov_words * 32, tid, nt,
                 [&](int b, int32_t k) { return blk.obs(b).hits[k]; });
  }
}

// load seeds [first, first + nb) of a.in into blk, with every thread of
// the block; ends with a block barrier
template <class M, int E, bool MET, bool OBS>
MADSIM_HD void block_load(const Block<M, E, MET, OBS>& blk, const Fields& f, int64_t first,
                          int nb, int tid, int nt) {
  constexpr int N = M::N, U = M::U, A = M::A, W = M::W;
  constexpr int NW = PoolBits<E>::NW;
  for (int x = tid; x < nb * NW; x += nt) blk[x / NW].ev_bits[x % NW] = 0;
  rows_in<1>(f.seed, first, nb, tid, nt,
             [&](int b, int, int64_t v) { blk[b].seed = static_cast<uint64_t>(v); });
  rows_in<1>(f.now, first, nb, tid, nt, [&](int b, int, int64_t v) { blk[b].now = v; });
  rows_in<1>(f.step, first, nb, tid, nt,
             [&](int b, int, int64_t v) { blk[b].step = static_cast<uint32_t>(v); });
  rows_in<1>(f.halted, first, nb, tid, nt,
             [&](int b, int, uint8_t v) { blk[b].halted = v != 0; });
  rows_in<1>(f.halt_time, first, nb, tid, nt,
             [&](int b, int, int64_t v) { blk[b].halt_time = v; });
  rows_in<1>(f.trace, first, nb, tid, nt,
             [&](int b, int, int64_t v) { blk[b].trace = static_cast<uint64_t>(v); });
  rows_in<1>(f.overflow, first, nb, tid, nt,
             [&](int b, int, int32_t v) { blk[b].overflow = v; });
  rows_in<1>(f.msg_count, first, nb, tid, nt,
             [&](int b, int, int64_t v) { blk[b].msg_count = v; });
  rows_in<1>(f.dup, first, nb, tid, nt,
             [&](int b, int, uint8_t v) { blk[b].dup = v != 0; });
  rows_in<E>(f.ev_time, first, nb, tid, nt,
             [&](int b, int k, int64_t v) { blk[b].ev_time[k] = v; });
  rows_in<E>(f.ev_meta, first, nb, tid, nt,
             [&](int b, int k, int64_t v) { blk[b].ev_meta[k] = static_cast<uint32_t>(v); });
  rows_in<E>(f.ev_epoch, first, nb, tid, nt,
             [&](int b, int k, int32_t v) { blk[b].ev_epoch[k] = v; });
  rows_in<E * A>(f.ev_args, first, nb, tid, nt,
                 [&](int b, int k, int32_t v) { blk[b].ev_args[k] = v; });
  rows_in<E * W>(f.ev_pay, first, nb, tid, nt,
                 [&](int b, int k, int32_t v) { blk[b].ev_pay[k] = v; });
  rows_in<N>(f.alive, first, nb, tid, nt,
             [&](int b, int k, uint8_t v) { blk[b].alive[k] = v != 0; });
  rows_in<N>(f.paused, first, nb, tid, nt,
             [&](int b, int k, uint8_t v) { blk[b].paused[k] = v != 0; });
  rows_in<N>(f.epoch, first, nb, tid, nt,
             [&](int b, int k, int32_t v) { blk[b].epoch[k] = v; });
  rows_in<N>(f.skew, first, nb, tid, nt,
             [&](int b, int k, int32_t v) { blk[b].skew[k] = v; });
  rows_in<N * U>(f.node_state, first, nb, tid, nt,
                 [&](int b, int k, int32_t v) { blk[b].node_state[k] = v; });
  rows_in<N * N>(f.clog, first, nb, tid, nt,
                 [&](int b, int k, uint8_t v) { blk[b].clog[k] = v != 0; });
  rows_in<N * N>(f.slow, first, nb, tid, nt,
                 [&](int b, int k, int32_t v) { blk[b].slow[k] = v; });
  if constexpr (M::R > 0) {
    rows_in<1>(f.hist_count, first, nb, tid, nt,
               [&](int b, int, int32_t v) { blk[b].hist_count = v; });
    rows_in<1>(f.hist_drop, first, nb, tid, nt,
               [&](int b, int, int32_t v) { blk[b].hist_drop = v; });
  }
  if constexpr (SyncOf<M>::value) {
    rows_in<N * U>(f.disk, first, nb, tid, nt,
                   [&](int b, int k, int32_t v) { blk[b].disk[k] = v; });
    rows_in<N * U>(f.wmask, first, nb, tid, nt,
                   [&](int b, int k, uint8_t v) { blk[b].wmask[k] = v != 0; });
    rows_in<N>(f.sync_loss, first, nb, tid, nt,
               [&](int b, int k, uint8_t v) { blk[b].sync_loss[k] = v != 0; });
    rows_in<N>(f.sync_eio, first, nb, tid, nt,
               [&](int b, int k, uint8_t v) { blk[b].sync_eio[k] = v != 0; });
    rows_in<N>(f.torn, first, nb, tid, nt,
               [&](int b, int k, uint8_t v) { blk[b].torn[k] = v != 0; });
  }
  if constexpr (MET) {
    rows_in<N_METRICS>(f.met, first, nb, tid, nt,
                       [&](int b, int k, int32_t v) { blk[b].met[k] = v; });
  }
  if constexpr (OBS) load_obs<M, E>(blk, f, first, nb, tid, nt);
  block_sync();  // the bits are zero before any thread sets one
  rows_in<E>(f.ev_valid, first, nb, tid, nt, [&](int b, int k, uint8_t v) {
    if (v) set_bit_shared(blk[b].ev_bits, k);
  });
  block_sync();
}

// store blk into seeds [first, first + nb) of f, every field the kernel
// writes; the caller has passed a block barrier
template <class M, int E, bool MET, bool OBS>
MADSIM_HD void block_store(const Block<M, E, MET, OBS>& blk, const Fields& f,
                           int64_t first, int nb, int tid, int nt) {
  constexpr int N = M::N, U = M::U, A = M::A, W = M::W;
  rows_out<1>(f.now, first, nb, tid, nt, [&](int b, int) { return blk[b].now; });
  rows_out<1>(f.step, first, nb, tid, nt,
              [&](int b, int) { return static_cast<int64_t>(blk[b].step); });
  rows_out<1>(f.halted, first, nb, tid, nt,
              [&](int b, int) { return static_cast<uint8_t>(blk[b].halted); });
  rows_out<1>(f.halt_time, first, nb, tid, nt,
              [&](int b, int) { return blk[b].halt_time; });
  rows_out<1>(f.trace, first, nb, tid, nt,
              [&](int b, int) { return static_cast<int64_t>(blk[b].trace); });
  rows_out<1>(f.overflow, first, nb, tid, nt, [&](int b, int) { return blk[b].overflow; });
  rows_out<1>(f.msg_count, first, nb, tid, nt,
              [&](int b, int) { return blk[b].msg_count; });
  rows_out<E>(f.ev_time, first, nb, tid, nt,
              [&](int b, int k) { return blk[b].ev_time[k]; });
  rows_out<E>(f.ev_valid, first, nb, tid, nt, [&](int b, int k) {
    return static_cast<uint8_t>(PoolBits<E>::get(blk[b].ev_bits, k));
  });
  rows_out<E>(f.ev_meta, first, nb, tid, nt,
              [&](int b, int k) { return static_cast<int64_t>(blk[b].ev_meta[k]); });
  rows_out<E>(f.ev_epoch, first, nb, tid, nt,
              [&](int b, int k) { return blk[b].ev_epoch[k]; });
  rows_out<E * A>(f.ev_args, first, nb, tid, nt,
                  [&](int b, int k) { return blk[b].ev_args[k]; });
  rows_out<E * W>(f.ev_pay, first, nb, tid, nt,
                  [&](int b, int k) { return blk[b].ev_pay[k]; });
  rows_out<N>(f.alive, first, nb, tid, nt,
              [&](int b, int k) { return static_cast<uint8_t>(blk[b].alive[k]); });
  rows_out<N>(f.paused, first, nb, tid, nt,
              [&](int b, int k) { return static_cast<uint8_t>(blk[b].paused[k]); });
  rows_out<N>(f.epoch, first, nb, tid, nt, [&](int b, int k) { return blk[b].epoch[k]; });
  rows_out<N * U>(f.node_state, first, nb, tid, nt,
                  [&](int b, int k) { return blk[b].node_state[k]; });
  rows_out<N * N>(f.clog, first, nb, tid, nt,
                  [&](int b, int k) { return static_cast<uint8_t>(blk[b].clog[k]); });
  rows_out<N * N>(f.slow, first, nb, tid, nt, [&](int b, int k) { return blk[b].slow[k]; });
  rows_out<N>(f.skew, first, nb, tid, nt, [&](int b, int k) { return blk[b].skew[k]; });
  rows_out<1>(f.dup, first, nb, tid, nt,
              [&](int b, int) { return static_cast<uint8_t>(blk[b].dup); });
  if constexpr (M::R > 0) {
    rows_out<1>(f.hist_count, first, nb, tid, nt,
                [&](int b, int) { return blk[b].hist_count; });
    rows_out<1>(f.hist_drop, first, nb, tid, nt,
                [&](int b, int) { return blk[b].hist_drop; });
  }
  if constexpr (SyncOf<M>::value) {
    rows_out<N * U>(f.disk, first, nb, tid, nt, [&](int b, int k) { return blk[b].disk[k]; });
    rows_out<N * U>(f.wmask, first, nb, tid, nt,
                    [&](int b, int k) { return static_cast<uint8_t>(blk[b].wmask[k]); });
    rows_out<N>(f.sync_loss, first, nb, tid, nt,
                [&](int b, int k) { return static_cast<uint8_t>(blk[b].sync_loss[k]); });
    rows_out<N>(f.sync_eio, first, nb, tid, nt,
                [&](int b, int k) { return static_cast<uint8_t>(blk[b].sync_eio[k]); });
    rows_out<N>(f.torn, first, nb, tid, nt,
                [&](int b, int k) { return static_cast<uint8_t>(blk[b].torn[k]); });
  }
  if constexpr (MET) {
    rows_out<N_METRICS>(f.met, first, nb, tid, nt, [&](int b, int k) { return blk[b].met[k]; });
  }
  if constexpr (OBS) store_obs<M, E>(blk, f, first, nb, tid, nt);
}

// Copy the block's history rows, seeds [first, first + nb), from the
// input to the output, every thread of the block, neighbouring threads
// on neighbouring words: rows past a seed's count come out as they went
// in. The appends of the run follow a block barrier (block_load's).
template <class M>
MADSIM_HD void copy_history(const Fields& in, const Fields& out, int32_t cap,
                            int64_t first, int nb, int tid, int nt) {
  if constexpr (M::R > 0) {
    const int64_t rows = static_cast<int64_t>(nb) * cap;
    const int32_t* wi = in.hist_word + first * cap * 5;
    int32_t* wo = out.hist_word + first * cap * 5;
    for (int64_t x = tid; x < rows * 5; x += nt) wo[x] = wi[x];
    const int64_t* ti = in.hist_t + first * cap;
    int64_t* to = out.hist_t + first * cap;
    for (int64_t x = tid; x < rows; x += nt) to[x] = ti[x];
  }
}

// Copy the block's timeline rows, seeds [first, first + nb), from the
// input to the output, as copy_history does: rows past a seed's count
// come out as they went in; with the causal axis its three columns too.
template <class M>
MADSIM_HD void copy_timeline(const Fields& in, const Fields& out, const EngineConfig& c,
                             int64_t first, int nb, int tid, int nt) {
  const int32_t cap = c.tl_cap;
  if (cap <= 0) return;
  const int64_t rows = static_cast<int64_t>(nb) * cap, at = first * cap;
  copy_bytes(out.tl_t + at, in.tl_t + at, rows * 8, tid, nt);
  copy_bytes(out.tl_meta + at, in.tl_meta + at, rows * 8, tid, nt);
  copy_bytes(out.tl_emit + at, in.tl_emit + at, rows * 8, tid, nt);
  copy_bytes(out.tl_args + at * M::A, in.tl_args + at * M::A, rows * M::A * 4, tid, nt);
  copy_bytes(out.tl_pay + at * M::W, in.tl_pay + at * M::W, rows * M::W * 4, tid, nt);
  if (c.causal) {
    copy_bytes(out.tl_seq + at, in.tl_seq + at, rows * 4, tid, nt);
    copy_bytes(out.tl_parent + at, in.tl_parent + at, rows * 4, tid, nt);
    copy_bytes(out.tl_lam + at, in.tl_lam + at, rows * 8, tid, nt);
  }
}

// Copy the block's latency rows, seeds [first, first + nb), from the
// input to the output, as copy_history does; the leader's folds then
// update the output in place. Nothing with the tap off or without
// markers (the output columns are then the input's).
template <class M>
MADSIM_HD void copy_latency(const Fields& in, const Fields& out, const EngineConfig& c,
                            int64_t first, int nb, int tid, int nt) {
  if constexpr (LatOf<M>::n > 0) {
    if (c.lat_c <= 0) return;
    const int64_t ops = static_cast<int64_t>(nb) * c.lat_c, at = first * c.lat_c;
    copy_bytes(out.lat_inv + at, in.lat_inv + at, ops * 8, tid, nt);
    copy_bytes(out.lat_resp + at, in.lat_resp + at, ops * 8, tid, nt);
    const int64_t hw = static_cast<int64_t>(c.lat_p) * kLatBuckets;
    copy_bytes(out.lat_hist + first * hw, in.lat_hist + first * hw, nb * hw * 4, tid, nt);
    copy_bytes(out.lat_count + first, in.lat_count + first, static_cast<int64_t>(nb) * 4,
               tid, nt);
    copy_bytes(out.lat_drop + first, in.lat_drop + first, static_cast<int64_t>(nb) * 4,
               tid, nt);
  }
}

// Copy the block's retry books, seeds [first, first + nb), from the input
// to the output, as copy_latency does; the leader then updates the output
// in place. Nothing without a policy or without markers.
template <class M>
MADSIM_HD void copy_retry(const Fields& in, const Fields& out, const RetryCfg& r,
                          int64_t first, int nb, int tid, int nt) {
  if constexpr (LatOf<M>::n > 0) {
    if (r.n_ops <= 0) return;
    const int64_t ops = static_cast<int64_t>(nb) * r.n_ops, at = first * r.n_ops;
    copy_bytes(out.rt_done + at, in.rt_done + at, ops, tid, nt);
    copy_bytes(out.rt_attempt + at, in.rt_attempt + at, ops * 4, tid, nt);
    copy_bytes(out.rt_deadline + at, in.rt_deadline + at, ops * 8, tid, nt);
  }
}

// Append a user dispatch's valid record rows at hist_count, hist_count +
// 1, ...: the row is [op, key, arg, client = dst, ok] and the time the
// dispatch clock `now` (without the node's skew). Rows past the capacity
// are dropped and counted, so the kept ones are a prefix. Returns the
// rows kept. The leader's work.
template <class M, int E, bool MET>
MADSIM_HDI int append_history(Seed<M, E, MET>& s, const HistOut<M::R>& ho,
                              const Rec* recs, int32_t dst, int64_t now) {
  int kept = 0;
  for (int j = 0; j < M::R; j++) {
    const Rec& r = recs[j];
    if (r.valid) {
      if (s.hist_count < ho.cap) {
        int32_t* w = ho.word + static_cast<int64_t>(s.hist_count) * 5;
        w[0] = r.op;
        w[1] = r.key;
        w[2] = r.arg;
        w[3] = dst;
        w[4] = r.ok;
        ho.t[s.hist_count] = now;
        s.hist_count += 1;
        kept++;
      } else {
        s.hist_drop += 1;
      }
    }
  }
  return kept;
}


// the reference's 32-bit feature finalizer
MADSIM_HDI uint32_t cov_mix(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// Fold one feature into the seed's bitmap; with hit counts its counter
// counts it first (saturating at 255) and the bit set is that of the
// feature keyed by the counter's class (edges 1, 2, 3, 4, 8, 16, 32,
// 128). The caller has checked the feature's gate.
MADSIM_HDI void cov_tap(const SeedObs& o, uint32_t feat) {
  const uint32_t mask = static_cast<uint32_t>(o.cw) * 32u - 1u;
  if (o.hc) {
    const uint32_t ci = cov_mix(feat) & mask;
    const uint32_t newc = o.hits[ci] < 255 ? o.hits[ci] + 1u : 255u;
    const uint32_t cls = (newc >= 2u) + (newc >= 3u) + (newc >= 4u) + (newc >= 8u) +
                         (newc >= 16u) + (newc >= 32u) + (newc >= 128u);
    o.hits[ci] = static_cast<uint8_t>(newc);
    feat ^= (cls + 1u) * 0x9E3779B9u;
  }
  const uint32_t bit = cov_mix(feat) & mask;
  o.cov[bit >> 5] |= 1u << (bit & 31u);
}

// floor(log2(x)) for x >= 2, else 0: the count of i in 1..31 with
// x >= 2^i, the reference's bucket of the causal feature
MADSIM_HDI uint32_t log2_bucket(uint32_t x) {
#ifdef __CUDA_ARCH__
  return x < 2u ? 0u : 31u - static_cast<uint32_t>(__clz(static_cast<int>(x)));
#else
  return x < 2u ? 0u : 31u - static_cast<uint32_t>(__builtin_clz(x));
#endif
}

// The causal feature (tag 7): the bucket of the folded clock and of the
// jump, how far the arriving event's clock was ahead of the node's
// (a difference in int64, clipped at 0: the same-node case is negative)
MADSIM_HDI uint32_t causal_feature(uint32_t lam_prev, uint32_t lam_new, uint32_t evlam) {
  const int64_t d = static_cast<int64_t>(evlam) - static_cast<int64_t>(lam_prev);
  const uint32_t jump = d > 0 ? static_cast<uint32_t>(d) : 0u;
  return log2_bucket(lam_new) | (log2_bucket(jump) << 8) | (7u << 24);
}

// The coverage taps of one dispatch, the leader's, in the reference's
// order: the kind transition at the node (user) or the kind by time
// phase (engine), the message edge, the user kind by phase, with the
// causal axis the causal feature (engine kinds too), each valid history
// record, each op the latency markers completed, the model's own
// features, then the node's last kind. `now` is the dispatch clock
// without the node's skew.
template <class M>
MADSIM_HDI void cov_taps(const SeedObs& o, const int32_t* node_state, int32_t kind,
                         int32_t dst, int32_t src, bool is_engine, bool in_range,
                         int64_t now, uint32_t causal_f, const Rec* recs,
                         [[maybe_unused]] const uint32_t* lat_f,
                         [[maybe_unused]] const bool* lat_on) {
  const uint32_t k = static_cast<uint32_t>(kind);
  const uint32_t du = static_cast<uint32_t>(dst > 0 ? dst : 0);
  const uint32_t su = static_cast<uint32_t>(src > 0 ? src : 0);
  const int64_t ph = now >> 27;
  const uint32_t phase = static_cast<uint32_t>(ph < 31 ? ph : 31);
  if (is_engine) {
    cov_tap(o, k | (phase << 8) | (1u << 24));
    if (o.causal) cov_tap(o, causal_f);
    return;
  }
  const int dst_c = clampi(dst, 0, M::N - 1);
  const uint32_t prev = static_cast<uint32_t>(in_range ? o.cov_last[dst_c] : 0);
  cov_tap(o, k | (prev << 8) | (du << 16));
  if (src >= 0) cov_tap(o, k | (su << 8) | (du << 16) | (3u << 24));
  cov_tap(o, k | (phase << 8) | (4u << 24));
  if (o.causal) cov_tap(o, causal_f);
  if constexpr (M::R > 0) {
    for (int j = 0; j < M::R; j++) {
      const Rec& r = recs[j];
      if (!r.valid) continue;
      cov_tap(o, (static_cast<uint32_t>(r.op) * 0x9E3779B1u) ^
                     (static_cast<uint32_t>(r.key) * 0x85EBCA6Bu) ^
                     (static_cast<uint32_t>(r.arg) * 0xC2B2AE35u) ^
                     static_cast<uint32_t>(r.ok) ^ (2u << 24));
    }
  }
  if constexpr (LatOf<M>::n > 0) {
    for (int j = 0; j < LatOf<M>::n; j++)
      if (lat_on[j]) cov_tap(o, lat_f[j]);
  }
  if constexpr (CovOf<M>::n > 0) {
    uint32_t feats[CovOf<M>::n];
    M::cov_features(node_state, feats);
    for (int f = 0; f < CovOf<M>::n; f++) cov_tap(o, (feats[f] & 0xFFFFFFu) | (6u << 24));
  }
  if (in_range) o.cov_last[dst_c] = kind;
}

// zero the emit rows (the re-send row too), row j by lane j mod G
template <class M, int G>
MADSIM_HDI void clear_rows(const Lanes<G>& g, Emit<M::A, M::W>* em) {
  constexpr int rows = M::K + 1 + (LatOf<M>::n > 0 ? 1 : 0);
  g.each([&](int l) {
    for (int j = l; j < rows; j += G) em[j].clear();
  });
}

// Place the dispatch's emit rows, lane l taking rows l, l + G, ...: loss,
// dead destinations and latency (its draw taken at the step's start),
// then the j-th surviving emit into the j-th free slot, its rank from a
// ballot and its slot from the free bits. Rows past the restart row are
// the shadow rows: user row j - K - 1 again, while `dup` is set and it
// is a send; after those, a model with markers has the re-send row (a
// timer, so it reads no draw). The lanes zero their rows for the next
// dispatch; the leader marks the slots taken and counts sends and
// overflow. With the causal axis every placed row's parent is the
// dispatch `seq` and its clock `lam_new`.
template <class M, int E, int G, bool MET, bool OBS>
MADSIM_HD void place_emits(const Lanes<G>& g, Seed<M, E, MET>& s,
                           const EngineConfig& c, int64_t now, int64_t now_after,
                           int32_t dst, bool in_range, int dst_c, const SeedObs& o,
                           [[maybe_unused]] int32_t seq, [[maybe_unused]] uint32_t lam_new) {
  constexpr int N = M::N, A = M::A, W = M::W, KR = M::K + 1, KT = Seed<M, E, MET>::KT;
  constexpr int RT = Seed<M, E, MET>::RT, KE = KT + RT;
  using B = PoolBits<E>;
  // row j's emit: a shadow row reads its user row, the re-send row its own
  auto row = [&](int j) -> const Emit<A, W>& {
    if constexpr (RT > 0) {
      if (j == KT) return s.em[KR];
    }
    return s.em[j < KR ? j : j - KR];
  };
  int kept = 0, sends = 0, lost_n = 0, dead_n = 0, dup_n = 0;
  for (int j0 = 0; j0 < KE; j0 += G) {
    PerLane<bool, G> keep, sent, lost, dead;
    PerLane<int64_t, G> when;
    g.each([&](int l) {
      keep[l] = false;
      sent[l] = false;
      lost[l] = false;
      dead[l] = false;
      when[l] = 0;
      const int j = j0 + l;
      if (j >= KE) return;
      const Emit<A, W>& e = row(j);
      bool shadow = j >= KR;
      if constexpr (RT > 0) shadow = shadow && j < KT;
      if (!e.valid || (shadow && !(e.send && s.dup))) return;
      const bool em_in_range = e.dst >= 0 && e.dst < N;
      const int em_c = clampi(e.dst, 0, N - 1);
      if (e.send) {
        sent[l] = true;
        const uint32_t l0 = s.lat0[j], l1 = s.lat1[j];
        lost[l] = static_cast<uint64_t>(l1) < c.loss_u32;
        dead[l] = !lost[l] && !(em_in_range && s.alive[em_c]);
        if (lost[l] || dead[l]) return;  // lost, or a dead destination
        int64_t lat = c.lat_min + static_cast<int64_t>(l0 % c.lat_span);
        const int32_t mult = (in_range && em_in_range) ? s.slow[dst_c * N + em_c] : 1;
        if (mult > 1) lat *= mult;
        when[l] = now_after + lat;
      } else {
        when[l] = now_after + e.delay;
      }
      keep[l] = true;
    });
    const uint32_t ballot = g.ballot(keep);
    sends += popc32(g.ballot(sent));
    if constexpr (MET) {
      lost_n += popc32(g.ballot(lost));
      dead_n += popc32(g.ballot(dead));
      // the lanes of this round that hold shadow rows (KR <= j < KT)
      const int first_dup = KR > j0 ? KR - j0 : 0;
      if (first_dup < G) {
        uint32_t dups = ballot >> first_dup;
        if constexpr (RT > 0) {
          const int rt_lane = KT - j0;  // the re-send row's lane, if this round's
          if (rt_lane >= first_dup && rt_lane < G) dups &= ~(1u << (rt_lane - first_dup));
        }
        dup_n += popc32(dups);
      }
    }
    g.each([&](int l) {
      if (!keep[l]) return;
      const int slot = B::nth_free(s.ev_bits, kept + popc32(ballot & ((1u << l) - 1u)));
      if (slot < 0) return;  // overflow, counted below
      const Emit<A, W>& e = row(j0 + l);
      const bool em_in_range = e.dst >= 0 && e.dst < N;
      const bool em_engine = e.kind < FIRST_USER_KIND || e.kind >= FIRST_EXT_KIND;
      const int32_t mk = e.kind < 0 ? KIND_NOP : (e.kind > 255 ? 255 : e.kind);
      const int32_t node1 = clampi(e.dst, -1, N) + 1;
      const int32_t src1 = e.send ? clampi(dst, -1, N) + 1 : 0;
      s.ev_time[slot] = when[l];
      s.ev_meta[slot] = static_cast<uint32_t>(mk) | (static_cast<uint32_t>(node1) << 8) |
                        (static_cast<uint32_t>(src1) << 16);
      s.ev_epoch[slot] =
          (em_engine || !em_in_range) ? 0 : s.epoch[clampi(e.dst, 0, N - 1)];
      for (int w = 0; w < A; w++) s.ev_args[slot * A + w] = e.args[w];
      for (int w = 0; w < W; w++) s.ev_pay[slot * W + w] = e.pay[w];
      // the row was emitted at this dispatch's clock, by this dispatch
      if constexpr (OBS) {
        if (o.tl_cap > 0) o.ev_emit[slot] = now;
        if (o.causal) {
          o.ev_parent[slot] = seq;
          o.ev_lam[slot] = lam_new;
        }
      }
    });
    kept += popc32(ballot);
  }
  clear_rows<M, G>(g, s.em);
  g.sync();  // every lane has read the free bits
  if (g.leader()) {
    s.msg_count += sends;
    s.overflow += kept - B::fill_first_free(s.ev_bits, kept);
    if constexpr (MET) {
      s.met[MET_SENT] += sends;
      s.met[MET_LOST] += lost_n;
      s.met[MET_DEAD_DROP] += dead_n;
      s.met[MET_DUP] += dup_n;
    }
  }
}

// One engine step of one seed on its lane group. Returns false when the
// pool held no valid event: such a step changes nothing but `step`, and
// so does every later one. Every lane computes the gates from the same
// shared words; the leader writes.
template <class M, int E, int G, bool MET, bool OBS>
MADSIM_HD bool engine_step(const Lanes<G>& g, Seed<M, E, MET>& s, const EngineConfig& c,
                           const typename M::Params& mp,
                           const int32_t* init_rows,
                           const uint8_t* volatile_cols,
                           const HistOut<M::R>& ho, const SeedObs& o,
                           [[maybe_unused]] const LatOut<LatOf<M>::n>& lo,
                           [[maybe_unused]] const RetryOut<LatOf<M>::n>& ro) {
  constexpr int N = M::N, U = M::U, A = M::A, W = M::W, K = M::K, H = M::H;
  constexpr int L = LatOf<M>::n;
  constexpr bool SYNC = SyncOf<M>::value;
  static_assert(A >= 2 && A <= 4, "engine kinds read args[0:2]");
  static_assert(H >= 1, "handler 0 is on_init");
  // ev_meta packs the kind and node + 1 in one byte each
  static_assert(FIRST_USER_KIND + H - 1 < 256, "user kinds fit a byte");
  static_assert(N < 255, "node + 1 fits a byte");
  constexpr int KR = K + 1, KT = Seed<M, E, MET>::KT, D = KT + UserDraws<M>::n;
  const uint32_t k0 = static_cast<uint32_t>(s.seed);
  const uint32_t k1 = static_cast<uint32_t>(s.seed >> 32);
  const uint32_t step = s.step;
  // ---- this step's draws, a few per lane, beside the pop: they depend
  // on (seed, step) alone; a step that dispatches nothing wastes them.
  // The emit rows' purposes, then the shadow rows', then the user's ----
  g.each([&](int l) {
    for (int d = l; d < D; d += G) {
      uint32_t x0, x1;
      const uint32_t purpose =
          d < KR ? PURPOSE_LATENCY + static_cast<uint32_t>(d)
                 : (d < KT ? PURPOSE_DUP + static_cast<uint32_t>(d - KR)
                           : PURPOSE_USER + UserDraws<M>::purpose(d - KT));
      threefry2x32(k0, k1, step, purpose, &x0, &x1);
      if (d < KT) {
        s.lat0[d] = x0;
        s.lat1[d] = x1;
      } else {
        s.user0[d - KT] = x0;
      }
    }
  });
  // poll cost (word 0) and clog-recheck jitter (word 1): one block, on
  // every lane, so that no lane waits for it
  uint32_t b0, b1;
  threefry2x32(k0, k1, step, PURPOSE_POLL_COST, &b0, &b1);
  // ---- pop the earliest pending event (first minimum) ----
  const int i = pop_slot<E, G>(g, s.ev_bits, s.ev_time);
  const bool has_event = PoolBits<E>::get(s.ev_bits, i);
  const int64_t ev_time_i = s.ev_time[i];
  const int64_t ev_t = ev_time_i > s.now ? ev_time_i : s.now;
  const bool over_limit = ev_t > c.time_limit;
  const bool was_halted = s.halted;
  const bool active = has_event && !was_halted && !over_limit;

  const uint32_t meta = s.ev_meta[i];
  const int32_t kind = static_cast<int32_t>(meta & 0xFFu);
  const int32_t dst = static_cast<int32_t>((meta >> 8) & 0xFFu) - 1;
  const int32_t src = static_cast<int32_t>((meta >> 16) & 0xFFu) - 1;
  const int32_t retries = static_cast<int32_t>((meta >> 24) & 0xFFu);
  // the popped event's words, copied: placement may reuse its slot
  int32_t args[A];
  int32_t pay[W > 0 ? W : 1];
  for (int j = 0; j < A; j++) args[j] = s.ev_args[i * A + j];
  for (int j = 0; j < W; j++) pay[j] = s.ev_pay[i * W + j];
  // when the popped event entered the pool (the ring's emit column)
  int64_t emit_i = 0;
  // and, with the causal axis, the dispatch that emitted it and its clock
  int32_t parent_i = PARENT_NONE;
  uint32_t evlam_i = 0;
  if constexpr (OBS) {
    if (o.tl_cap > 0) emit_i = o.ev_emit[i];
    if (o.causal) {
      parent_i = o.ev_parent[i];
      evlam_i = o.ev_lam[i];
    }
  }
  const int32_t a0 = args[0], a1 = args[1];
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
      is_msg && in_range && s.clog[clampi(src, 0, N - 1) * N + dst_c];
  const bool held = !is_engine && paused_dst;
  const bool blocked = clogged || held;
  const bool dispatch = active && !blocked && (is_engine || live);
  const bool resched = active && blocked && (is_engine || live);

  const int64_t now = active ? ev_t : s.now;
  const int64_t now_after =
      dispatch ? now + c.proc_min + static_cast<int64_t>(b0 % c.proc_span) : now;
  // the causal fold's values: the dispatch's seq and the node's clock
  // after the Lamport receive, read before the leader writes it
  const int32_t seq = static_cast<int32_t>(step < kSeqMax ? step : kSeqMax);
  [[maybe_unused]] uint32_t lam_prev = 0;
  uint32_t lam_new = 0;
  if constexpr (OBS) {
    if (o.causal) {
      lam_prev = in_range ? o.lam[dst_c] : 0u;
      lam_new = (lam_prev > evlam_i ? lam_prev : evlam_i) + 1u;
    }
  }
  g.sync();  // every lane has read the popped slot; the draws are stored
  if (g.leader()) {
    if (resched) {
      const int shift = retries < 34 ? retries : 34;
      int64_t backoff = static_cast<int64_t>(
          static_cast<uint64_t>(c.backoff_min) << shift);
      if (backoff > c.backoff_max) backoff = c.backoff_max;
      backoff += static_cast<int64_t>(b1 % 1000u);
      s.ev_time[i] = now + backoff;
      const uint32_t bumped = static_cast<uint32_t>(retries + 1 < 255 ? retries + 1 : 255);
      s.ev_meta[i] = (meta & 0x00FFFFFFu) | (bumped << 24);
    } else {
      // consume the popped slot (a halted seed's step drains it too)
      s.ev_bits[i >> 5] &= ~(1u << (i & 31));
    }
  }

  if (dispatch) {
    if (g.leader()) {
      // the client-retry decode, with a policy on: an army row delivers
      // unless its op has its response (read before this dispatch's
      // markers) or it carries the give-up attempt; a suppressed row
      // runs no handler. Always false for a model without markers
      bool suppress = false;
      [[maybe_unused]] bool is_army = false, arm = false, done_i = false;
      [[maybe_unused]] int32_t rt_idx = 0, rt_att = 0;
      if constexpr (L > 0) {
        const RetryCfg& rc = *ro.cfg;
        if (rc.n_ops > 0 && !is_engine) {
          rt_idx = (a0 & kRetryOpMask) - rc.op_base;
          rt_att = (a0 >> kRetryShift) & kRetryAttemptMax;
          is_army = kind == rc.kind && dst == rc.node && rt_idx >= 0 && rt_idx < rc.n_ops;
          if (is_army) {
            done_i = ro.done[rt_idx] != 0;
            arm = !done_i && rt_att < rc.max_attempts;
            suppress = !arm;
          }
        }
      }
      // the handler's history records and latency markers, and the ops
      // the markers completed (the coverage taps read them too)
      Rec recs[M::R > 0 ? M::R : 1];
      [[maybe_unused]] Lat lats[L > 0 ? L : 1];
      [[maybe_unused]] uint32_t lat_f[L > 0 ? L : 1];
      [[maybe_unused]] bool lat_on[L > 0 ? L : 1];
      if constexpr (L > 0) {
        for (int j = 0; j < L; j++) {
          lats[j].valid = false;
          lats[j].op = lats[j].phase = 0;
          lat_on[j] = false;
        }
      }
      if (!is_engine && !suppress) {
        // user dispatch implies a live, in-range node
        int32_t* row = s.node_state + dst_c * U;
        for (int u = 0; u < U; u++) s.new_row[u] = row[u];
        bool fsync = false;
        Ctx<M> ctx;
        ctx.state = row;
        ctx.node = dst;
        ctx.src = src;
        ctx.args = args;
        ctx.pay = pay;
        ctx.now = now + static_cast<int64_t>(s.skew[dst_c]);
        ctx.k0 = k0;
        ctx.k1 = k1;
        ctx.step = step;
        ctx.drawn = s.user0;
        ctx.sync_flag = &fsync;
        int32_t n_lat = 0;
        ctx.lats = L > 0 ? lats : nullptr;
        ctx.n_lat = &n_lat;
        if constexpr (SYNC) {
          ctx.sync_err = s.sync_eio[dst_c];
        } else {
          ctx.sync_err = false;
        }
        const int32_t h = clampi(kind - FIRST_USER_KIND, 0, H - 1);
        if constexpr (M::R > 0) {
          for (int j = 0; j < M::R; j++) recs[j].clear();
          M::handle(h, ctx, mp, s.new_row, s.em, recs);
          const int kept = append_history<M, E, MET>(s, ho, recs, dst, now);
          if constexpr (MET) s.met[MET_RECORD] += kept;
        } else {
          M::handle(h, ctx, mp, s.new_row, s.em, nullptr);
        }
        if constexpr (L > 0) {
          if (lo.c > 0) lat_fold<L>(lo, lats, now, lat_f, lat_on);
        }
        if constexpr (SYNC) {
          // the changed durable columns, against the row before the
          // dispatch, replace the node's write mask
          bool wrote = false;
          for (int u = 0; u < U; u++)
            wrote = wrote || (!volatile_cols[u] && s.new_row[u] != row[u]);
          if (wrote)
            for (int u = 0; u < U; u++)
              s.wmask[dst_c * U + u] = !volatile_cols[u] && s.new_row[u] != row[u];
        }
        for (int u = 0; u < U; u++) row[u] = s.new_row[u];
        if constexpr (SYNC) {
          // the commit, unless the node's disk lies or fails
          const bool lying = s.sync_loss[dst_c] || s.sync_eio[dst_c];
          if (fsync && !lying) {
            for (int u = 0; u < U; u++) {
              if (!volatile_cols[u]) s.disk[dst_c * U + u] = row[u];
              s.wmask[dst_c * U + u] = false;
            }
          }
          if constexpr (MET) {
            s.met[MET_SYNC] += fsync && !lying;
            s.met[MET_SYNC_LOST] += fsync && lying;
          }
        }
      } else if (kind == KIND_KILL || kind == KIND_RESTART) {
        const bool restart = kind == KIND_RESTART;
        if (a0 >= 0 && a0 < N) {
          s.alive[a0] = restart;
          s.paused[a0] = false;
          s.epoch[a0] += 1;
          if (restart) {
            for (int u = 0; u < U; u++)
              if (volatile_cols[u]) s.node_state[a0 * U + u] = init_rows[a0 * U + u];
          }
          if constexpr (SYNC) {
            if (!restart) {
              // the crash: the durable columns revert to the disk image;
              // an armed torn mode keeps the first keep_cnt dirty ones
              uint32_t keep_cnt = 0;
              if (s.torn[a0]) {
                uint32_t n_dirty = 0;
                for (int u = 0; u < U; u++) n_dirty += s.wmask[a0 * U + u];
                uint32_t x0, x1;
                threefry2x32(k0, k1, step, PURPOSE_TORN, &x0, &x1);
                keep_cnt = x0 % (n_dirty + 1u);
              }
              uint32_t rank = 0;
              for (int u = 0; u < U; u++) {
                const int x = a0 * U + u;
                const bool dirty = s.wmask[x];
                if (!volatile_cols[u]) {
                  if (!(dirty && rank < keep_cnt)) s.node_state[x] = s.disk[x];
                  s.disk[x] = s.node_state[x];
                }
                rank += dirty;
                s.wmask[x] = false;
              }
              if constexpr (MET) s.met[MET_TORN] += s.torn[a0];
            }
          }
        }
        // the reborn node re-runs on_init: a timer row after the user
        // slots, zero args and payload
        if (restart) s.em[K].after(true, 0, FIRST_USER_KIND, a0);
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
            if (sel) s.clog[x * N + y] = on;
          }
      } else if (kind == KIND_CLOG_1W || kind == KIND_UNCLOG_1W) {
        // one direction: src a0 -> dst a1
        if (a0 >= 0 && a0 < N && a1 >= 0 && a1 < N)
          s.clog[a0 * N + a1] = kind == KIND_CLOG_1W;
      } else if (kind == KIND_SLOW_LINK || kind == KIND_UNSLOW) {
        // the packed peer (-1: every link of a0) and multiplier; each
        // selected cell is overwritten
        const int32_t b = (a1 & 0xFF) - 1;
        const int32_t shifted = a1 >> 8;  // arithmetic, as the plain step
        const int32_t mult = kind == KIND_UNSLOW ? 1 : (shifted > 1 ? shifted : 1);
        for (int x = 0; x < N; x++)
          for (int y = 0; y < N; y++) {
            const bool sel = (x == a0 && y == b) || (x == b && y == a0) ||
                             (b < 0 && (x == a0 || y == a0));
            if (sel) s.slow[x * N + y] = mult;
          }
      } else if (kind == KIND_DUP_ON || kind == KIND_DUP_OFF) {
        s.dup = kind == KIND_DUP_ON;
      } else if (kind == KIND_SKEW) {
        if (a0 >= 0 && a0 < N) s.skew[a0] = a1;
      } else if (kind >= KIND_SYNC_LOSS && kind <= KIND_TORN_OFF) {
        // the storage windows of node a0, or of every node (a0 < 0);
        // SYNC_LOSS with a1 == 1 opens the observable EIO window
        if constexpr (SYNC) {
          for (int x = 0; x < N; x++) {
            if (!(x == a0 || a0 < 0)) continue;
            if (kind == KIND_SYNC_LOSS) {
              if (a1 == 1) s.sync_eio[x] = true;
              else s.sync_loss[x] = true;
            } else if (kind == KIND_SYNC_OK) {
              s.sync_loss[x] = false;
              s.sync_eio[x] = false;
            } else {
              s.torn[x] = kind == KIND_TORN_ON;
            }
          }
        }
      }
      if constexpr (L > 0) {
        const RetryCfg& rc = *ro.cfg;
        if (rc.n_ops > 0) {
          // the books: an op this user dispatch marked responded (a
          // lat_end marker) is done
          if (!is_engine && !suppress) {
            for (int j = 0; j < L; j++) {
              const int32_t x = lats[j].op - rc.op_base;
              if (lats[j].valid && lats[j].phase == 1 && x >= 0 && x < rc.n_ops) ro.done[x] = 1;
            }
          }
          if (arm) {
            // the re-send: the next attempt's token, a timer at timeout
            // + backoff + jitter (int64: bjit < 2^31, the draw < 2^32),
            // and the armed op's attempt and deadline
            const int32_t next = rt_att + 1;
            int64_t boff = 0, bjit = 0;
            for (int a = 1; a <= kRetryAttemptMax; a++) {
              if (next == a) {
                boff = rc.boff[a];
                bjit = rc.bjit[a];
              }
            }
            uint32_t x0, x1;
            threefry2x32(k0, k1, step, PURPOSE_RETRY, &x0, &x1);
            const int64_t delay = rc.timeout_ns + boff + ((bjit * static_cast<int64_t>(x0)) >> 32);
            ro.attempt[rt_idx] = rt_att;
            ro.deadline[rt_idx] = now_after + delay;
            Emit<A, W>& e = s.em[K + 1];
            e.after(true, delay, rc.kind, rc.node, (a0 & kRetryOpMask) | (next << kRetryShift),
                    a1);
            for (int j = 2; j < A; j++) e.args[j] = args[j];
          }
        }
      }
      if constexpr (OBS) {
        if (o.causal && in_range) o.lam[dst_c] = lam_new;
        if (o.cw > 0) {
          const uint32_t causal_f = o.causal ? causal_feature(lam_prev, lam_new, evlam_i) : 0u;
          if (suppress) {
            // a suppressed row taps no user feature, only the causal one
            if (o.causal) cov_tap(o, causal_f);
          } else {
            cov_taps<M>(o, s.node_state, kind, dst, src, is_engine, in_range, now, causal_f,
                        recs, lat_f, lat_on);
          }
        }
      }
      if constexpr (MET) {
        s.met[MET_DELIVERED] += is_msg;
        s.met[MET_CRASH] += kind == KIND_KILL;
        s.met[MET_RESTART] += kind == KIND_RESTART;
        s.met[MET_PAUSE] += kind == KIND_PAUSE;
        s.met[MET_TIMER] += !is_engine && !is_msg && !suppress;
        if constexpr (L > 0) {
          // a re-delivery is a delivered army row past attempt 0; a
          // give-up the sentinel popping with its op unanswered
          s.met[MET_RETRY] += arm && rt_att > 0;
          s.met[MET_RETRY_GIVEUP] += is_army && !done_i && rt_att == ro.cfg->max_attempts;
        }
      }
    }
    g.sync();
    place_emits<M, E, G, MET, OBS>(g, s, c, now, now_after, dst, in_range, dst_c, o, seq,
                                   lam_new);
  }

  // ---- halt, trace, clock ----
  if (g.leader()) {
    const bool halted =
        was_halted || (dispatch && kind == KIND_HALT) || (has_event && over_limit);
    if (halted && !was_halted) s.halt_time = now < c.time_limit ? now : c.time_limit;
    s.halted = halted;
    if constexpr (MET) {
      // the step's threefry blocks: the poll block, every emit row's,
      // with the discipline the torn word's and with a retry policy the
      // jitter's
      constexpr int blocks = 1 + KT + (SYNC ? 1 : 0);
      int rt_blocks = 0;
      if constexpr (L > 0) rt_blocks = ro.cfg->n_ops > 0 ? 1 : 0;
      if (active) s.met[MET_RNG] += blocks + rt_blocks;
      s.met[MET_CLOG_BLOCK] += active && clogged;
      if (halted && !was_halted) {
        s.met[MET_HALT_CODE] = dispatch && kind == KIND_HALT ? HALT_DONE : HALT_TIME_LIMIT;
      } else if (!has_event && !was_halted && s.met[MET_HALT_CODE] == HALT_RUNNING) {
        s.met[MET_HALT_CODE] = HALT_IDLE;
      }
    }
    if (OBS && dispatch && o.tl_cap > 0) {
      // the ring: this dispatch's row, the tuple the trace folds
      const int32_t t = o.tl[0];
      if (t < o.tl_cap) {
        o.ring_t[t] = now;
        o.ring_meta[t] = static_cast<int64_t>(meta);
        for (int j = 0; j < A; j++) o.ring_args[t * A + j] = args[j];
        for (int j = 0; j < W; j++) o.ring_pay[t * W + j] = pay[j];
        o.ring_emit[t] = emit_i;
        if (o.causal) {
          o.ring_seq[t] = seq;
          o.ring_parent[t] = parent_i;
          o.ring_lam[t] = static_cast<int64_t>(lam_new);
        }
        o.tl[0] = t + 1;
      } else {
        o.tl[1] += 1;
      }
    }
    if (dispatch) s.trace = trace_fold<A, W>(s.trace, now, kind, dst, args, pay);
    s.now = now_after;
    s.step = step + 1u;
  }
  g.sync();
  return has_event;
}

// Up to `budget` steps of one seed on its group. With stop_at_halt the
// seed stops at its halt and the return value is the steps it took;
// without, it takes all `budget` steps (a halted seed drains). Either way
// each iteration advances `step` exactly as the plain step would. A
// group that returns early still reaches its block's barrier.
template <class M, int E, int G, bool MET, bool OBS>
MADSIM_HD int64_t seed_run(const Lanes<G>& g, Seed<M, E, MET>& s, const EngineConfig& c,
                           const typename M::Params& mp,
                           const int32_t* init_rows,
                           const uint8_t* volatile_cols, int64_t budget,
                           bool stop_at_halt, const HistOut<M::R>& ho,
                           const SeedObs& o, const LatOut<LatOf<M>::n>& lo,
                           const RetryOut<LatOf<M>::n>& ro) {
  clear_rows<M, G>(g, s.em);
  g.sync();
  int64_t it = 0;
  while (it < budget) {
    if (s.halted) {
      if (stop_at_halt) return it;
      drain_slots<E, G>(g, s.ev_bits, s.ev_time, budget - it);
      if (g.leader()) s.step += static_cast<uint32_t>(budget - it);
      return budget;
    }
    const bool had_event =
        engine_step<M, E, G, MET, OBS>(g, s, c, mp, init_rows, volatile_cols, ho, o, lo, ro);
    it++;
    if (!had_event && !s.halted) {
      // an empty pool stays empty: the rest only counts steps
      if (g.leader()) s.step += static_cast<uint32_t>(budget - it);
      return budget;
    }
  }
  return it;
}

// One block of the run kernel: load its seeds [first, first + nb), run
// each on its lane group (group b of the block is threads b G .. b G +
// G - 1), store. On the host the calling thread is the whole block and
// plays each group in turn. Returns the largest iteration count this
// thread saw, for tmax.
// seed `seed`'s rows of the run's output history (nothing when R == 0)
template <class M>
MADSIM_HDI HistOut<M::R> hist_out(const RunArgs& a, int64_t seed) {
  HistOut<M::R> ho;
  if constexpr (M::R > 0) {
    ho.cap = a.cfg.hist_cap;
    ho.word = a.out.hist_word + seed * a.cfg.hist_cap * 5;
    ho.t = a.out.hist_t + seed * a.cfg.hist_cap;
  }
  return ho;
}

// seed `seed`'s latency columns: its rows of the run's output (nothing
// when the model has no markers)
template <class M>
MADSIM_HDI LatOut<LatOf<M>::n> lat_out(const RunArgs& a, int64_t seed) {
  LatOut<LatOf<M>::n> lo;
  if constexpr (LatOf<M>::n > 0) {
    const EngineConfig& c = a.cfg;
    lo.c = c.lat_c;
    lo.p = c.lat_p;
    lo.phase_ns = c.lat_phase_ns;
    lo.inv = a.out.lat_inv + seed * c.lat_c;
    lo.resp = a.out.lat_resp + seed * c.lat_c;
    lo.hist = a.out.lat_hist + seed * c.lat_p * kLatBuckets;
    lo.count = a.out.lat_count + seed;
    lo.drop = a.out.lat_drop + seed;
  }
  return lo;
}

// seed `seed`'s retry books: its rows of the run's output, and the run's
// policy (nothing when the model has no markers)
template <class M>
MADSIM_HDI RetryOut<LatOf<M>::n> retry_out(const RunArgs& a, int64_t seed) {
  RetryOut<LatOf<M>::n> ro;
  if constexpr (LatOf<M>::n > 0) {
    const int64_t n = a.rt.n_ops;
    ro.cfg = &a.rt;
    ro.done = a.out.rt_done + seed * n;
    ro.attempt = a.out.rt_attempt + seed * n;
    ro.deadline = a.out.rt_deadline + seed * n;
  }
  return ro;
}

// seed `seed`'s observability state: block seed b's shared tail and its
// rows of the run's output ring
template <class M, int E, bool MET, bool OBS>
MADSIM_HDI SeedObs seed_obs(const Block<M, E, MET, OBS>& blk, int b, const RunArgs& a,
                            int64_t seed) {
  SeedObs o{};
  if constexpr (OBS) {
    o = blk.obs(b);
    const int64_t t = a.cfg.tl_cap;
    if (t > 0) {
      o.ring_t = a.out.tl_t + seed * t;
      o.ring_meta = a.out.tl_meta + seed * t;
      o.ring_args = a.out.tl_args + seed * t * M::A;
      o.ring_pay = a.out.tl_pay + seed * t * M::W;
      o.ring_emit = a.out.tl_emit + seed * t;
      if (a.cfg.causal) {
        o.ring_seq = a.out.tl_seq + seed * t;
        o.ring_parent = a.out.tl_parent + seed * t;
        o.ring_lam = a.out.tl_lam + seed * t;
      }
    }
  }
  return o;
}

template <class M, int E, int G, bool MET, bool OBS>
MADSIM_HD int64_t run_block(const Block<M, E, MET, OBS>& blk, const RunArgs& a,
                            const typename M::Params& mp, int64_t first,
                            int nb, int tid, int nt) {
  copy_history<M>(a.in, a.out, a.cfg.hist_cap, first, nb, tid, nt);
  copy_latency<M>(a.in, a.out, a.cfg, first, nb, tid, nt);
  copy_retry<M>(a.in, a.out, a.rt, first, nb, tid, nt);
  if constexpr (OBS) copy_timeline<M>(a.in, a.out, a.cfg, first, nb, tid, nt);
  block_load<M, E, MET, OBS>(blk, a.in, first, nb, tid, nt);
  int64_t most = 0;
  const bool stop = a.stop_at_halt != 0;
#ifdef __CUDA_ARCH__
  const int b = tid / G;
  if (b < nb) {
    const Lanes<G> g(tid);
    const int64_t it = seed_run<M, E, G, MET, OBS>(g, blk[b], a.cfg, mp, a.init_rows,
                                              a.volatile_cols, a.budget, stop,
                                              hist_out<M>(a, first + b),
                                              seed_obs<M, E, MET, OBS>(blk, b, a, first + b),
                                              lat_out<M>(a, first + b),
                                              retry_out<M>(a, first + b));
    if (g.leader()) {
      a.iters[first + b] = it;
      most = it;
    }
  }
#else
  for (int b = 0; b < nb; b++) {
    const Lanes<G> g(0);
    const int64_t it = seed_run<M, E, G, MET, OBS>(g, blk[b], a.cfg, mp, a.init_rows,
                                              a.volatile_cols, a.budget, stop,
                                              hist_out<M>(a, first + b),
                                              seed_obs<M, E, MET, OBS>(blk, b, a, first + b),
                                              lat_out<M>(a, first + b),
                                              retry_out<M>(a, first + b));
    a.iters[first + b] = it;
    most = it > most ? it : most;
  }
#endif
  block_sync();
  block_store<M, E, MET, OBS>(blk, a.out, first, nb, tid, nt);
  return most;
}

// One seed's share of the drain kernel's shared memory: its valid bits
// as loaded and as drained, its event times (read where valid) and its
// remaining steps.
template <int E>
struct DrainSeed {
  int64_t ev_time[E];
  int64_t r;
  uint32_t bits[PoolBits<E>::NW];
  uint32_t loaded[PoolBits<E>::NW];
};

// One block of the drain kernel: seeds [first, first + nb) each take
// their r = tmax - iters remaining halted steps (drain_slots). It reads
// `step`, `ev_valid` and, where a slot is valid, `ev_time`; it writes the
// slots it clears and `step`. A seed with r == 0 is not touched.
template <int E, int G>
MADSIM_HD void drain_block(DrainSeed<E>* blk, const DrainArgs& d, int64_t first,
                           int nb, int tid, int nt) {
  constexpr int NW = PoolBits<E>::NW;
  const int64_t t = *d.tmax;
  for (int b = tid; b < nb; b += nt) blk[b].r = t - d.iters[first + b];
  for (int x = tid; x < nb * NW; x += nt) blk[x / NW].bits[x % NW] = 0;
  block_sync();
  const uint8_t* valid = d.ev_valid + first * E;
  const int64_t* time = d.ev_time + first * E;
  for (int x = tid; x < nb * E; x += nt) {
    DrainSeed<E>& s = blk[x / E];
    if (s.r <= 0 || !valid[x]) continue;
    set_bit_shared(s.bits, x % E);
    s.ev_time[x % E] = time[x];
  }
  block_sync();
  for (int x = tid; x < nb * NW; x += nt) blk[x / NW].loaded[x % NW] = blk[x / NW].bits[x % NW];
  block_sync();
#ifdef __CUDA_ARCH__
  const int b = tid / G;
  if (b < nb && blk[b].r > 0) {
    const Lanes<G> g(tid);
    drain_slots<E, G>(g, blk[b].bits, blk[b].ev_time, blk[b].r);
    if (g.leader()) d.step[first + b] += blk[b].r;
  }
#else
  for (int b = 0; b < nb; b++) {
    if (blk[b].r <= 0) continue;
    drain_slots<E, G>(Lanes<G>(0), blk[b].bits, blk[b].ev_time, blk[b].r);
    d.step[first + b] += blk[b].r;
  }
#endif
  block_sync();
  uint8_t* out = d.ev_valid + first * E;
  for (int x = tid; x < nb * E; x += nt) {
    const DrainSeed<E>& s = blk[x / E];
    const int e = x % E;
    if (PoolBits<E>::get(s.loaded, e) && !PoolBits<E>::get(s.bits, e)) out[x] = 0;
  }
}

}  // namespace madsim
