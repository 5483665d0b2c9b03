// Sharded KV with key-range migration under chaos
// (madsim_tpu_torch/models/shardkv.py, default variant) as a model trait
// of the run kernel (engine_step.cuh): a controller, a client and G_
// groups of GS_ replicas, NS_ shards (n_groups, group_size and n_shards;
// by default four groups of three, N = 14, and eight shards, U = 2 * 8 +
// 1 = 17), fifteen handlers. Every column is durable, so a RESTART keeps the
// whole row; the restart's re-init runs on_init, which leaves the row
// alone. Shard assignments pack 4 bits per shard into two words. RECORD
// is the record variant (shardkv-record): committed writes and shard
// installs append history records. BUG (shardkv-bug, with RECORD) plants
// the lost-shard mutant: the source wipes the shard as it sends the
// handoff, so a retried handoff installs version 0. CHAOS = false drops
// the seed's own kill and restart (a fault plan brings its own). ARMY is
// the army=True variant: three more handlers take a chaos.ClientArmy's
// ops at the client, each an exactly-once put (a dedup floor in client
// column 3, an OP_ARMY_PUT record with RECORD) and a PROBES-round
// session of probes to the controller, its invoke and completion marked
// for the latency tap (L = 1 marker row a call). NOIDEM (with RECORD and
// ARMY) is bug="noidem", the non-idempotent retried put: the apply skips
// the floor, so every delivered attempt applies and records.
#pragma once

#include "engine_step.cuh"

namespace madsim {

template <bool RECORD = false, bool BUG = false, bool CHAOS = true, bool ARMY = false,
          int PROBES = 1, bool NOIDEM = false, int G_ = 4, int GS_ = 3, int NS_ = 8>
struct ShardKvModel {
  static_assert(RECORD || !BUG, "the planted fault needs recording");
  static_assert(!NOIDEM || (RECORD && ARMY && !BUG),
                "noidem lives in the recorded army apply, apart from the lost shard");
  static_assert(PROBES >= 1, "an op takes at least one probe round");
  static_assert(G_ >= 1 && G_ <= 15, "4-bit group ids");
  static_assert(NS_ >= 1 && NS_ <= 8, "packed 4-bit assignment words");
  static_assert(GS_ >= 1, "a group has its primary");
  static constexpr int G = G_, GS = GS_, NS = NS_;  // groups, group size, shards
  // the controller's scalars need columns 0..7; on_write's GS + 1 rows,
  // or init's six
  static constexpr int N = 2 + G * GS, U = 2 * NS + 1 > 8 ? 2 * NS + 1 : 8, A = 3, W = 0;
  static constexpr int K = GS + 1 > 6 ? GS + 1 : 6;
  static constexpr int H = ARMY ? 18 : 15;
  static constexpr int R = RECORD ? 1 : 0;  // history records per call
  static constexpr int L = ARMY ? 1 : 0;    // latency markers per call
  // history op codes (check.shard_coverage) and the install record's
  // packed arg (check/history.py pack_shard_own)
  static constexpr int32_t OP_SHARD_WRITE = OP_USER, OP_SHARD_OWN = OP_USER + 1,
                           OP_ARMY_PUT = OP_USER + 2;
  static MADSIM_HDI int32_t pack_own(int32_t epoch, int32_t group, int32_t ver) {
    return (epoch << 20) | (group << 16) | (ver & 0xFFFF);
  }
  static constexpr int32_t CONTROLLER = 0, CLIENT = 1, FROZEN = 2 * NS;
  static constexpr int32_t VER_CAP = (1 << 16) - 1, EPOCH_CAP = 255;
  static constexpr int32_t A_MASK = 0xFFFF;

  struct Params {
    int32_t writes, n_migs;
    int64_t put_ns, mig_ns, retx_ns;
  };
  // words: writes, n_migs, put_ms, mig_ms, retx_ms
  static Params params(const int64_t* w) {
    return Params{static_cast<int32_t>(w[0]), static_cast<int32_t>(w[1]),
                  w[2] * 1000000, w[3] * 1000000, w[4] * 1000000};
  }

  // controller columns; the client keeps its epoch in 0, its acked
  // count in 1 and its assignment words in 4 and 5
  static constexpr int32_t EPOCH = 0, PHASE = 1, MIG_S = 2, MIG_D = 3, A0 = 4,
                           A1 = 5, DONE = 6, FIN = 7, ACKED = 1;
  // the client's last army op applied plus one: the exactly-once floor
  static constexpr int32_t APPLIED = 3;

  // protocol coverage (Workload.cov_features, the engine's CovOf): the
  // migration edge the controller is on and the fleet's shard ownership
  // count
  static constexpr int NCOV = 2;
  static MADSIM_HDI void cov_features(const int32_t* ns, uint32_t* f) {
    const int32_t* ctl = ns + CONTROLLER * U;
    const uint32_t ep = static_cast<uint32_t>(ctl[EPOCH] < 255 ? ctl[EPOCH] : 255);
    const uint32_t ph = static_cast<uint32_t>(clampi(ctl[PHASE], 0, 1));
    const uint32_t ms = static_cast<uint32_t>(clampi(ctl[MIG_S], 0, 7));
    f[0] = ep | (ph << 8) | (ms << 9) | (1u << 20);
    uint32_t owned = 0;
    for (int g = 0; g < G; g++)
      for (int s = 0; s < NS; s++) owned += ns[(2 + g * GS) * U + NS + s] > 0;
    f[1] = (owned < 63u ? owned : 63u) | (1u << 21);
  }
  static constexpr int32_t K_PUT_T = FIRST_USER_KIND + 1;
  static constexpr int32_t K_WRITE = FIRST_USER_KIND + 2;
  static constexpr int32_t K_REPL = FIRST_USER_KIND + 3;
  static constexpr int32_t K_WRITE_OK = FIRST_USER_KIND + 4;
  static constexpr int32_t K_WRONG = FIRST_USER_KIND + 5;
  static constexpr int32_t K_CFG_REQ = FIRST_USER_KIND + 6;
  static constexpr int32_t K_CFG = FIRST_USER_KIND + 7;
  static constexpr int32_t K_MIG_T = FIRST_USER_KIND + 8;
  static constexpr int32_t K_MIG_RETX = FIRST_USER_KIND + 9;
  static constexpr int32_t K_MIG_START = FIRST_USER_KIND + 10;
  static constexpr int32_t K_HANDOFF = FIRST_USER_KIND + 11;
  static constexpr int32_t K_INSTALL_ACK = FIRST_USER_KIND + 12;
  static constexpr int32_t K_RELEASE = FIRST_USER_KIND + 13;
  static constexpr int32_t K_FIN = FIRST_USER_KIND + 14;
  static constexpr int32_t K_APROBE = FIRST_USER_KIND + 16;
  static constexpr int32_t K_ARESP = FIRST_USER_KIND + 17;
  static constexpr uint32_t P_KILL_AT = 0, P_KILL_WHO = 1, P_REVIVE = 2;

  using Em = Emit<A, W>;
  using C = Ctx<ShardKvModel>;

  // shard -> group from the packed words
  static MADSIM_HDI int32_t group_of(int32_t a0, int32_t a1, int32_t s) {
    return ((s < 4 ? a0 : a1) >> ((s & 3) * 4)) & 0xF;
  }
  static MADSIM_HDI int32_t primary_of(int32_t g) { return 2 + g * GS; }
  static MADSIM_HDI int32_t shard_of(const C& c) { return clampi(c.args[0], 0, NS - 1); }
  static MADSIM_HDI int32_t min32(int32_t a, int32_t b) { return a < b ? a : b; }

  // (re)drive the open migration: an idempotent MIG_START to the
  // shard's current owner
  static MADSIM_HDI void mig_start_row(Em& e, const int32_t* st, bool when) {
    const int32_t s = st[MIG_S];
    e.to(when, primary_of(group_of(st[A0], st[A1], s)), K_MIG_START, s,
         min32(st[EPOCH] + 1, EPOCH_CAP));
    e.args[2] = st[MIG_D];
  }

  // the army handlers, 15..17: an op arrives at the client, applies an
  // exactly-once put (ops come in increasing id order, so op >= floor
  // admits each once) and opens a session; the controller echoes each
  // probe; the client chains the next round, and the last response
  // completes the op. The token's op id and attempt are unpacked (the
  // attempt is 0 without retries).
  static MADSIM_HDI void army(int32_t h, const C& c, int32_t* ns, Em* em,
                              [[maybe_unused]] Rec* rec) {
    if (h == 15) {
      const int32_t op = c.args[0] & ((int32_t(1) << 26) - 1);
      const int32_t att = (c.args[0] >> 26) & 15;
      const bool applied = NOIDEM || op >= c.state[APPLIED];
      if (applied) ns[APPLIED] = clampi(op + 1, 0, VER_CAP);
      if constexpr (RECORD) rec[0].record(applied, OP_ARMY_PUT, op, att, OK_OK);
      c.lat_start(true, op);
      em[0].to(true, CONTROLLER, K_APROBE, op, PROBES - 1);
    } else if (h == 16) {
      em[0].to(true, CLIENT, K_ARESP, c.args[0], c.args[1]);
    } else {
      const int32_t op = c.args[0], left = c.args[1];
      em[0].to(left > 0, CONTROLLER, K_APROBE, op, left - 1);
      c.lat_end(left == 0, op);
    }
  }

  static MADSIM_HD void handle(int32_t h, const C& c, const Params& p,
                               int32_t* ns, Em* em, [[maybe_unused]] Rec* rec) {
    const int32_t* st = c.state;
    if constexpr (ARMY) {
      if (h >= 15) {
        army(h, c, ns, em, rec);
        return;
      }
    }
    switch (h) {
      case 0: {  // on_init
        em[0].after(c.node == CONTROLLER, p.mig_ns, K_MIG_T, CONTROLLER);
        em[1].after(c.node == CLIENT, p.put_ns, K_PUT_T, CLIENT);
        if (CHAOS && c.node == CLIENT) {  // the seed's kill and restart of a primary
          const int32_t who =
              2 + static_cast<int32_t>(c.user_int(0, G, P_KILL_WHO)) * GS;
          const int64_t at = c.user_int(20000000, 300000000, P_KILL_AT);
          const int64_t revive = c.user_int(100000000, 600000000, P_REVIVE);
          em[2].after(true, at, KIND_KILL, 0, who);
          em[3].after(true, at + revive, KIND_RESTART, 0, who);
        }
        break;
      }
      case 1: {  // on_put_t at the client: one outstanding write
        const bool done = st[ACKED] >= p.writes;
        const int32_t seq = min32(st[ACKED] + 1, VER_CAP);
        const int32_t s = seq % NS;  // seq >= 1
        em[0].to(!done, primary_of(group_of(st[A0], st[A1], s)), K_WRITE, s, seq);
        em[1].to(done, CONTROLLER, K_FIN);
        em[2].after(true, p.put_ns, K_PUT_T, CLIENT);
        break;
      }
      case 2: {  // on_write at a primary: args = (shard, seq)
        const int32_t s = shard_of(c), seq = clampi(c.args[1], 0, VER_CAP);
        const bool serving = st[NS + s] > 0 && ((st[FROZEN] >> s) & 1) == 0;
        const bool fresh = serving && seq > st[s];
        if (fresh) ns[s] = seq;
        if constexpr (RECORD) rec[0].record(fresh, OP_SHARD_WRITE, s, seq, OK_OK);
        em[0].to(serving, CLIENT, K_WRITE_OK, s, seq);
        em[1].to(!serving, CLIENT, K_WRONG, s);
        // replicate the committed version inside the group
        const int32_t base = 2 + floordiv(c.node - 2, GS) * GS;
        for (int32_t i = 1; i < GS; i++) em[1 + i].to(fresh, base + i, K_REPL, s, seq);
        break;
      }
      case 3: {  // on_repl at a backup: args = (shard, ver)
        const int32_t s = shard_of(c), v = clampi(c.args[1], 0, VER_CAP);
        if (v > st[s]) ns[s] = v;
        break;
      }
      case 4: {  // on_write_ok at the client: args = (shard, seq)
        const int32_t seq = clampi(c.args[1], 0, VER_CAP);
        if (seq > st[ACKED]) ns[ACKED] = seq;
        break;
      }
      case 5: {  // on_wrong at the client: refetch the configuration
        em[0].to(true, CONTROLLER, K_CFG_REQ);
        break;
      }
      case 6: {  // on_cfg_req at the controller
        em[0].to(true, CLIENT, K_CFG, st[EPOCH], st[A0]);
        em[0].args[2] = st[A1];
        break;
      }
      case 7: {  // on_cfg at the client: args = (epoch, assign0, assign1)
        const int32_t e = clampi(c.args[0], 0, EPOCH_CAP);
        if (e > st[EPOCH]) {
          ns[EPOCH] = e;
          ns[A0] = clampi(c.args[1], 0, A_MASK);
          ns[A1] = clampi(c.args[2], 0, A_MASK);
        }
        break;
      }
      case 8: {  // on_mig_t, the controller's rebalance timer
        const bool more = st[DONE] < p.n_migs;
        const bool start = st[PHASE] == 0 && more;
        if (start) {
          const int32_t s = st[DONE] % NS;  // done >= 0
          ns[PHASE] = 1;
          ns[MIG_S] = s;
          ns[MIG_D] = (group_of(st[A0], st[A1], s) + 1) % G;
        }
        mig_start_row(em[0], ns, start);
        em[1].after(start, p.retx_ns, K_MIG_RETX, CONTROLLER);
        em[2].after(more, p.mig_ns, K_MIG_T, CONTROLLER);
        break;
      }
      case 9: {  // on_mig_retx: re-drive until the install is confirmed
        const bool open = st[PHASE] == 1;
        mig_start_row(em[0], st, open);
        em[1].after(open, p.retx_ns, K_MIG_RETX, CONTROLLER);
        break;
      }
      case 10: {  // on_mig_start at the source: args = (shard, epoch, dst)
        const int32_t s = shard_of(c);
        const bool owned = st[NS + s] > 0;
        if constexpr (BUG) {
          // the planted lost-shard mutant: "handoff sent" counts as
          // "migration done", so the source wipes the shard at once
          em[0].to(true, primary_of(clampi(c.args[2], 0, G - 1)), K_HANDOFF, s,
                   clampi(c.args[1], 0, EPOCH_CAP));
          em[0].args[2] = st[s];
          if (owned) {
            ns[s] = 0;
            ns[NS + s] = 0;
          }
        } else {
          // freeze and hand off; keep the shard until RELEASE
          em[0].to(owned, primary_of(clampi(c.args[2], 0, G - 1)), K_HANDOFF, s,
                   clampi(c.args[1], 0, EPOCH_CAP));
          em[0].args[2] = st[s];
          if (owned) ns[FROZEN] = st[FROZEN] | (int32_t(1) << s);
        }
        break;
      }
      case 11: {  // on_handoff at the destination: args = (shard, epoch, ver)
        const int32_t s = shard_of(c);
        const int32_t new_ep = clampi(c.args[1], 0, EPOCH_CAP);
        const int32_t v = clampi(c.args[2], 0, VER_CAP);
        const int32_t ver_new = st[s] > v ? st[s] : v;
        if constexpr (RECORD)
          rec[0].record(st[NS + s] < new_ep, OP_SHARD_OWN, s,
                        pack_own(new_ep, floordiv(c.node - 2, GS), ver_new < VER_CAP ? ver_new : VER_CAP),
                        OK_OK);
        if (st[NS + s] < new_ep) {
          ns[s] = ver_new;
          ns[NS + s] = new_ep;
          // installing also clears a stale frozen bit for the shard
          ns[FROZEN] = st[FROZEN] & (A_MASK ^ (int32_t(1) << s));
        }
        // always ack: a lost ack must not wedge the migration
        em[0].to(true, CONTROLLER, K_INSTALL_ACK, s, new_ep);
        break;
      }
      case 12: {  // on_install_ack at the controller: args = (shard, epoch)
        const int32_t s = shard_of(c), e = clampi(c.args[1], 0, EPOCH_CAP);
        const bool match =
            st[PHASE] == 1 && s == st[MIG_S] && e == min32(st[EPOCH] + 1, EPOCH_CAP);
        if (match) {
          // commit: shard s moves to the migration's group
          const int32_t sh = (s & 3) * 4;
          const int32_t g = clampi(st[MIG_D], 0, G - 1);
          const int32_t keep = A_MASK ^ (0xF << sh);
          if (s < 4) {
            ns[A0] = (st[A0] & keep) | (g << sh);
          } else {
            ns[A1] = (st[A1] & keep) | (g << sh);
          }
          ns[EPOCH] = e;
          ns[PHASE] = 0;
          ns[DONE] = min32(st[DONE] + 1, EPOCH_CAP);
        }
        em[0].to(match, primary_of(group_of(st[A0], st[A1], s)), K_RELEASE, s, e);
        em[1].to(match, CLIENT, K_CFG, ns[EPOCH], ns[A0]);
        em[1].args[2] = ns[A1];
        em[2].after(ns[FIN] > 0 && ns[DONE] >= p.n_migs, 0, KIND_HALT, 0);
        break;
      }
      case 13: {  // on_release at the source: drop the frozen copy
        const int32_t s = shard_of(c);
        if ((st[FROZEN] >> s) & 1) {
          ns[s] = 0;
          ns[NS + s] = 0;
          ns[FROZEN] = st[FROZEN] & (A_MASK ^ (int32_t(1) << s));
        }
        break;
      }
      default: {  // 14, on_fin at the controller: the client is done
        ns[FIN] = 1;
        em[0].after(st[DONE] >= p.n_migs, 0, KIND_HALT, 0);
        break;
      }
    }
  }
};

}  // namespace madsim
