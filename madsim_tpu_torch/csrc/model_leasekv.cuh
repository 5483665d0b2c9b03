// Lease/watch KV service under chaos (madsim_tpu_torch/models/leasekv.py,
// default variant) as a model trait of the run kernel (engine_step.cuh):
// a lease server, C_ clients (n_clients, three by default) and a watcher,
// fifteen handlers. Lease
// deadlines are int32 milliseconds of the handling node's own clock:
// Ctx::now, which is the engine clock plus the node's skew, as in the
// plain step's HandlerCtx.now. RECORD is the record variant
// (leasekv-record): the lease lifecycle, served puts and the watch
// stream append history records, C record rows a call (the scan records
// one expiry per lease). BUG (leasekv-bug, with RECORD) plants
// grant-after-expiry: a keepalive renews an expired lease too. ARMY is
// the army=True variant: three more handlers open the watcher to a
// chaos.ClientArmy, each op a PROBES-round session of read-only probes
// against the server, its invoke and completion marked for the latency
// tap (L = 1 marker row a call). CHAOS = false is the variant without
// the model's own kill and restart (chaos=False): on_init emits four
// rows and draws nothing. STALL (by default the variant without chaos)
// takes a sixth word, ka_stop_ms: client 1 stalls its keepalives once
// its own clock passes that many ms (a word past any clock, as
// engine/fused.py passes for None, never stalls); with CHAOS too it is
// the stall under the model's own kill and restart.
#pragma once

#include "engine_step.cuh"

namespace madsim {

template <bool RECORD = false, bool BUG = false, bool ARMY = false, int PROBES = 1,
          bool CHAOS = true, int C_ = 3, bool STALL = !CHAOS>
struct LeaseKvModel {
  static_assert(RECORD || !BUG, "the planted fault needs recording");
  static_assert(PROBES >= 1, "an op takes at least one probe round");
  static_assert(C_ >= 1 && C_ <= 30, "the fin mask holds every client");
  static constexpr int C = C_;  // clients; lease id = node id
  // the scan's C + 1 rows, or init's six
  static constexpr int N = C + 2, U = C + 3, A = 2, W = 0, K = C + 1 > 6 ? C + 1 : 6;
  static constexpr int H = ARMY ? 18 : 15;
  static constexpr int R = RECORD ? C : 0;  // history records per call
  static constexpr int L = ARMY ? 1 : 0;    // latency markers per call
  // history op codes (check.lease_safety)
  static constexpr int32_t OP_PUT = OP_USER, OP_EXPIRE = OP_USER + 1,
                           OP_WATCH_EVT = OP_USER + 2;
  static constexpr int32_t SERVER = 0, WATCHER = C + 1;
  static constexpr int32_t WSEQ = C, FIN_MASK = C + 1, EXP_CNT = C + 2;
  static constexpr int32_t full_mask = (1 << C) - 1;
  static constexpr int64_t HORIZON_MS = 300000;
  static constexpr int32_t WSEQ_CAP = (1 << 16) - 1, EVT_CAP = (1 << 16) - 1;

  struct Params {
    int32_t puts, ttl_ms;
    int64_t ka_ns, scan_ns, put_ns, ka_stop_ms;
  };
  // words: puts, ttl_ms, ka_ms, scan_ms, put_ms, and with STALL
  // ka_stop_ms
  static Params params(const int64_t* w) {
    return Params{static_cast<int32_t>(w[0]), static_cast<int32_t>(w[1]),
                  w[2] * 1000000, w[3] * 1000000, w[4] * 1000000,
                  STALL ? w[5] : INT64_MAX};
  }

  static constexpr int32_t K_GRANT = FIRST_USER_KIND + 1;
  static constexpr int32_t K_GRANTED = FIRST_USER_KIND + 2;
  static constexpr int32_t K_KA_T = FIRST_USER_KIND + 3;
  static constexpr int32_t K_KEEPALIVE = FIRST_USER_KIND + 4;
  static constexpr int32_t K_KA_REJ = FIRST_USER_KIND + 5;
  static constexpr int32_t K_SCAN = FIRST_USER_KIND + 6;
  static constexpr int32_t K_PUT_T = FIRST_USER_KIND + 7;
  static constexpr int32_t K_PUT = FIRST_USER_KIND + 8;
  static constexpr int32_t K_PUT_OK = FIRST_USER_KIND + 9;
  static constexpr int32_t K_PUT_REJ = FIRST_USER_KIND + 10;
  static constexpr int32_t K_FIN = FIRST_USER_KIND + 11;
  static constexpr int32_t K_WEVT = FIRST_USER_KIND + 12;
  static constexpr int32_t K_RESYNC = FIRST_USER_KIND + 13;
  static constexpr int32_t K_RESYNC_OK = FIRST_USER_KIND + 14;
  static constexpr int32_t K_APROBE = FIRST_USER_KIND + 16;
  static constexpr int32_t K_ARESP = FIRST_USER_KIND + 17;
  static constexpr uint32_t P_KILL_AT = 0, P_KILL_WHO = 1, P_REVIVE = 2;

  using Em = Emit<A, W>;
  using Cx = Ctx<LeaseKvModel>;

  // the node's observed clock in ms, clamped to [0, HORIZON_MS]; a
  // negative clock clamps to 0 under floor and truncating division alike
  static MADSIM_HDI int32_t local_ms(int64_t now) {
    if (now < 0) return 0;
    const int64_t ms = now / 1000000;
    return static_cast<int32_t>(ms < HORIZON_MS ? ms : HORIZON_MS);
  }

  static MADSIM_HDI int32_t lid_of(const Cx& c) { return clampi(c.args[0], 1, C); }

  static MADSIM_HDI int32_t min32(int32_t a, int32_t b) { return a < b ? a : b; }

  // protocol coverage (Workload.cov_features, the engine's CovOf): which
  // leases are live, the expiry count and the watcher's stream lag
  static constexpr int NCOV = 2;
  static MADSIM_HDI void cov_features(const int32_t* ns, uint32_t* f) {
    const int32_t* srv = ns + SERVER * U;
    uint32_t live = 0;
    for (int32_t lid = 1; lid <= C; lid++) live |= static_cast<uint32_t>(srv[lid - 1] > 0) << lid;
    const uint32_t exp = static_cast<uint32_t>(min32(srv[EXP_CNT], 15));
    const uint32_t lag = static_cast<uint32_t>(clampi(srv[WSEQ] - ns[WATCHER * U], 0, 15));
    f[0] = live | (exp << 8) | (1u << 16);
    f[1] = lag | (1u << 17);
  }

  // the army handlers, 15..17: an op arrives at the watcher and opens a
  // session; the server echoes each probe; the watcher chains the next
  // round, and the last response completes the op
  static MADSIM_HDI void army(int32_t h, const Cx& c, Em* em) {
    if (h == 15) {
      c.lat_start(true, c.args[0]);
      em[0].to(true, SERVER, K_APROBE, c.args[0], PROBES - 1);
    } else if (h == 16) {
      em[0].to(true, WATCHER, K_ARESP, c.args[0], c.args[1]);
    } else {
      const int32_t op = c.args[0], left = c.args[1];
      em[0].to(left > 0, SERVER, K_APROBE, op, left - 1);
      c.lat_end(left == 0, op);
    }
  }

  static MADSIM_HD void handle(int32_t h, const Cx& c, const Params& p,
                               int32_t* ns, Em* em, [[maybe_unused]] Rec* rec) {
    const int32_t* st = c.state;
    if constexpr (ARMY) {
      if (h >= 15) {
        army(h, c, em);
        return;
      }
    }
    switch (h) {
      case 0: {  // on_init
        // a client (re)grants its lease and starts its timers, at t=0
        // and again after a restart
        const bool is_client = c.node >= 1 && c.node <= C;
        em[0].to(is_client, SERVER, K_GRANT, c.node);
        em[1].after(is_client, p.ka_ns, K_KA_T, c.node);
        em[2].after(is_client, p.put_ns, K_PUT_T, c.node);
        em[3].after(c.node == SERVER, p.scan_ns, K_SCAN, SERVER);
        if (CHAOS && c.node == WATCHER) {  // the seed's chaos schedule
          const int32_t who = static_cast<int32_t>(c.user_int(1, 1 + C, P_KILL_WHO));
          const int64_t at = c.user_int(20000000, 300000000, P_KILL_AT);
          const int64_t revive = c.user_int(100000000, 600000000, P_REVIVE);
          em[4].after(true, at, KIND_KILL, 0, who);
          em[5].after(true, at + revive, KIND_RESTART, 0, who);
        }
        break;
      }
      case 1: {  // on_grant at the server: args = (lid,)
        const int32_t lid = lid_of(c);
        ns[lid - 1] = local_ms(c.now) + p.ttl_ms;
        if constexpr (RECORD) rec[0].record(true, OP_EXPIRE, lid, ns[lid - 1], OK_OK);
        em[0].to(true, lid, K_GRANTED);
        break;
      }
      case 2: {  // on_granted at a client
        ns[0] = 1;
        break;
      }
      case 3: {  // on_ka_t, the keepalive timer at a client
        // client 1 stalls once its own clock passes ka_stop_ms
        const bool stalled = STALL && c.node == 1 && local_ms(c.now) >= p.ka_stop_ms;
        em[0].to(st[0] > 0 && !stalled, SERVER, K_KEEPALIVE, c.node);
        em[1].after(true, p.ka_ns, K_KA_T, c.node);
        break;
      }
      case 4: {  // on_keepalive at the server: args = (lid,)
        const int32_t lid = lid_of(c);
        // the planted fault renews an expired lease, with no grant record
        const bool renew = BUG || st[lid - 1] > 0;
        if (renew) ns[lid - 1] = local_ms(c.now) + p.ttl_ms;
        em[0].to(!renew, lid, K_KA_REJ);
        break;
      }
      case 5:     // on_ka_rej and
      case 10: {  // on_put_rej at a client: the lease expired, re-grant
        ns[0] = 0;
        break;
      }
      case 6: {  // on_scan at the server: expire every passed deadline
        const int32_t now_ms = local_ms(c.now);
        const int32_t wseq = st[WSEQ];
        int32_t fired = 0;
        for (int32_t lid = 1; lid <= C; lid++) {
          const int32_t d = st[lid - 1];
          const bool exp = d > 0 && now_ms >= d;
          if (exp) ns[lid - 1] = 0;
          em[lid - 1].to(exp, WATCHER, K_WEVT, lid, min32(wseq + fired + 1, WSEQ_CAP));
          if constexpr (RECORD) rec[lid - 1].record(exp, OP_EXPIRE, lid, now_ms, OK_FAIL);
          fired += exp ? 1 : 0;
        }
        ns[WSEQ] = min32(wseq + fired, WSEQ_CAP);
        ns[EXP_CNT] = min32(st[EXP_CNT] + fired, EVT_CAP);
        em[C].after(true, p.scan_ns, K_SCAN, SERVER);
        break;
      }
      case 7: {  // on_put_t, the client's progress loop
        const bool granted = st[0] > 0;
        const int32_t acked = st[1];
        const bool done = acked >= p.puts;
        em[0].to(!granted && !done, SERVER, K_GRANT, c.node);
        em[1].to(granted && !done, SERVER, K_PUT, c.node, acked + 1);
        em[2].to(done, SERVER, K_FIN, c.node);
        em[3].after(true, p.put_ns, K_PUT_T, c.node);
        break;
      }
      case 8: {  // on_put at the server: args = (lid, seq)
        const int32_t lid = lid_of(c);
        const bool live = st[lid - 1] > 0;
        const int32_t seq = clampi(c.args[1], 0, p.puts);
        if constexpr (RECORD) rec[0].record(live, OP_PUT, lid, seq, OK_OK);
        em[0].to(live, lid, K_PUT_OK, seq);
        em[1].to(!live, lid, K_PUT_REJ);
        break;
      }
      case 9: {  // on_put_ok at a client: args = (seq,)
        const int32_t seq = clampi(c.args[0], 0, p.puts);
        if (seq > st[1]) ns[1] = seq;
        break;
      }
      case 11: {  // on_fin at the server: args = (lid,)
        const int32_t mask = st[FIN_MASK] | (int32_t(1) << (lid_of(c) - 1));
        ns[FIN_MASK] = mask;
        em[0].after(mask == full_mask, 0, KIND_HALT, 0);
        break;
      }
      case 12: {  // on_wevt at the watcher: args = (lid, wseq)
        const int32_t seq = clampi(c.args[1], 0, WSEQ_CAP);
        const bool gap = seq > st[0] + 1;
        const bool in_order = seq == st[0] + 1;
        if (in_order) {  // append
          ns[0] = seq;
          ns[1] = min32(st[1] + 1, EVT_CAP);
        }
        if constexpr (RECORD)
          rec[0].record(in_order, OP_WATCH_EVT, clampi(c.args[0], 0, C), seq, OK_OK);
        if (gap) ns[2] = min32(st[2] + 1, EVT_CAP);
        em[0].to(gap, SERVER, K_RESYNC, st[0]);
        break;
      }
      case 13: {  // on_resync at the server: send the stream head
        em[0].to(true, WATCHER, K_RESYNC_OK, st[WSEQ]);
        break;
      }
      default: {  // 14, on_resync_ok at the watcher: args = (wseq,)
        // adopt the stream head and record the explicit resync marker
        const int32_t w = clampi(c.args[0], 0, WSEQ_CAP);
        if (w > st[0]) ns[0] = w;
        if constexpr (RECORD) rec[0].record(w > st[0], OP_WATCH_EVT, 0, w, OK_FAIL);
        break;
      }
    }
  }
};

}  // namespace madsim
