// Replicated KV under kill/restart chaos
// (madsim_tpu_torch/models/kvchaos.py) as a model trait of the run
// kernel (engine_step.cuh): primary, NR_ replicas (n_replicas, four by
// default) and a client, twelve handlers. KvChaosModel<true> is the payload variant (kvchaos-payload):
// each WRITE carries two client-drawn value words in the event payload,
// the primary stores and re-replicates them, replicas store them.
// RECORD is the record variant (kvchaos-record): the client records its
// writes and the reads it probes the primary with, three record rows a
// call. BUG (kvchaos-bug, with RECORD) plants the lost-write fault: a
// replica's join also resets the primary's commit point. CHAOS = false
// is the variant without the model's own kill and restart (chaos=False,
// for fault plans): on_init emits four rows, not six. ARMY is the
// army=True variant with NR replicas: three more handlers open the
// client surface to a chaos.ClientArmy, each op a PROBES-round session
// of read-only probes through the primary, its invoke and completion
// marked for the latency tap (L = 1 marker row a call).
#pragma once

#include "engine_step.cuh"

namespace madsim {

template <bool PAYLOAD, bool RECORD = false, bool BUG = false, bool CHAOS = true,
          bool ARMY = false, int NR_ = 4, int PROBES = 1>
struct KvChaosModel {
  static_assert(RECORD || !BUG, "the planted fault needs recording");
  static_assert(NR_ >= 1 && NR_ <= 30, "the ack mask holds every replica");
  static_assert(PROBES >= 1, "an op takes at least one probe round");
  static constexpr int NR = NR_;  // replicas
  static constexpr int N = NR + 2, U = PAYLOAD ? 6 : 4, A = 2;
  // the retransmit's NR + 2 rows, or init's six
  static constexpr int W = PAYLOAD ? 2 : 0, K = NR + 2 > 6 ? NR + 2 : 6, H = ARMY ? 15 : 12;
  static constexpr int R = RECORD ? 3 : 0;  // history records per call
  static constexpr int L = ARMY ? 1 : 0;    // latency markers per call
  static constexpr int32_t CLIENT = N - 1;
  static constexpr int32_t majority = NR / 2 + 1;
  static constexpr int32_t full_mask = (1 << NR) - 1;

  struct Params {
    int32_t writes;
    int64_t retx_ns, client_retx_ns;
  };
  static Params params(const int64_t* w) {
    return Params{static_cast<int32_t>(w[0]), w[1], w[2]};
  }

  static constexpr int32_t PRIMARY = 0;
  static constexpr int32_t K_WRITE = FIRST_USER_KIND + 1;
  static constexpr int32_t K_REPL = FIRST_USER_KIND + 2;
  static constexpr int32_t K_ACK = FIRST_USER_KIND + 3;
  static constexpr int32_t K_COMMIT = FIRST_USER_KIND + 4;
  static constexpr int32_t K_RETX = FIRST_USER_KIND + 5;
  static constexpr int32_t K_CRETX = FIRST_USER_KIND + 6;
  static constexpr int32_t K_FIN = FIRST_USER_KIND + 7;
  static constexpr int32_t K_JOIN = FIRST_USER_KIND + 8;
  static constexpr int32_t K_JRETX = FIRST_USER_KIND + 9;
  static constexpr int32_t K_READ = FIRST_USER_KIND + 10;
  static constexpr int32_t K_READRESP = FIRST_USER_KIND + 11;
  static constexpr int32_t K_APROBE = FIRST_USER_KIND + 13;
  static constexpr int32_t K_ARESP = FIRST_USER_KIND + 14;
  static constexpr uint32_t P_KILL_AT = 0, P_KILL_WHO = 1, P_REVIVE = 2;
  static constexpr uint32_t P_VAL0 = 8, P_VAL1 = 9;

  using Em = Emit<A, W>;
  using C = Ctx<KvChaosModel>;

  // a WRITE to the primary, with two fresh client-drawn words as its
  // payload in the payload variant
  static MADSIM_HDI void write(Em& e, const C& c, bool when, int32_t seq) {
    e.to(when, PRIMARY, K_WRITE, seq);
    if constexpr (PAYLOAD) {
      if (when) {
        e.pay[0] = static_cast<int32_t>(c.user(P_VAL0));
        e.pay[1] = static_cast<int32_t>(c.user(P_VAL1));
      }
    }
  }

  // rows 0..NR-1: REPL to each replica whose ack bit is clear
  static MADSIM_HDI void replicate(Em* em, int32_t seq, bool when,
                                   int32_t mask, const int32_t* st) {
    for (int32_t i = 0; i < NR; i++) {
      em[i].to(when && ((mask >> i) & 1) == 0, i + 1, K_REPL, seq);
      for (int j = 0; j < W; j++) em[i].pay[j] = st[4 + j];
    }
  }

  static MADSIM_HDI void maybe_halt(Em& e, const Params& p, int32_t committed,
                                    int32_t mask, int32_t fin) {
    e.after(committed >= p.writes && mask == full_mask && fin > 0, 0,
            KIND_HALT, 0);
  }

  // the army handlers, 12..14: an op arrives at the client (its token's
  // op id is stripped of retry bits, the identity without retries) and
  // opens a session; the primary echoes each probe; the client chains
  // the next round, and the last response completes the op
  static MADSIM_HDI void army(int32_t h, const C& c, Em* em) {
    if (h == 12) {
      const int32_t op = c.args[0] & ((int32_t(1) << 26) - 1);
      c.lat_start(true, op);
      em[0].to(true, PRIMARY, K_APROBE, op, PROBES - 1);
    } else if (h == 13) {
      em[0].to(true, CLIENT, K_ARESP, c.args[0], c.args[1]);
    } else {
      const int32_t op = c.args[0], left = c.args[1];
      em[0].to(left > 0, PRIMARY, K_APROBE, op, left - 1);
      c.lat_end(left == 0, op);
    }
  }

  static MADSIM_HD void handle(int32_t h, const C& c, const Params& p,
                               int32_t* ns, Em* em, [[maybe_unused]] Rec* rec) {
    const int32_t* st = c.state;
    if constexpr (ARMY) {
      if (h >= 12) {
        army(h, c, em);
        return;
      }
    }
    switch (h) {
      case 0: {  // on_init
        const bool is_client = c.node == CLIENT;
        const bool is_replica = c.node >= 1 && c.node <= NR;
        // the client kicks off write 1 and its progress-retry timer
        write(em[0], c, is_client, 1);
        // write 1 is invoked here (retries are the same op)
        if constexpr (RECORD) rec[0].record(is_client, OP_WRITE, 0, 1, OK_PENDING);
        em[1].after(is_client, p.client_retx_ns, K_CRETX, CLIENT);
        // replicas announce themselves, at t=0 and after a restart
        em[2].to(is_replica, PRIMARY, K_JOIN, c.node);
        em[3].after(is_replica, p.retx_ns, K_JRETX, c.node);
        if (CHAOS && is_client) {  // the seed's chaos schedule
          const int32_t who = static_cast<int32_t>(c.user_int(1, 1 + NR, P_KILL_WHO));
          const int64_t at = c.user_int(20000000, 300000000, P_KILL_AT);
          const int64_t revive = c.user_int(100000000, 600000000, P_REVIVE);
          em[4].after(true, at, KIND_KILL, 0, who);
          em[5].after(true, at + revive, KIND_RESTART, 0, who);
        }
        break;
      }
      case 1: {  // on_write at the primary: args = (seq,)
        const int32_t seq = c.args[0];
        const bool fresh = seq > st[0] && seq > st[1];
        if (fresh) {
          ns[1] = seq;
          ns[2] = 0;
          // the first WRITE to arrive for a seq fixes its value
          for (int j = 0; j < W; j++) ns[4 + j] = c.pay[j];
        }
        replicate(em, seq, fresh, 0, ns);
        em[NR].after(fresh, p.retx_ns, K_RETX, PRIMARY, seq);
        break;
      }
      case 2: {  // on_repl at a replica: args = (seq,)
        const int32_t seq = c.args[0];
        ns[0] = st[0] > seq ? st[0] : seq;
        ns[1] = st[1] + 1;
        if (seq > st[0])
          for (int j = 0; j < W; j++) ns[2 + j] = c.pay[j];
        em[0].to(true, PRIMARY, K_ACK, seq, c.node);
        break;
      }
      case 3: {  // on_ack at the primary: args = (seq, replica)
        const int32_t seq = c.args[0], who = c.args[1];
        const bool current = seq == st[1];
        const int32_t mask = current ? (st[2] | (int32_t(1) << (who - 1))) : st[2];
        int32_t acks = 0;
        for (int32_t i = 0; i < NR; i++) acks += (mask >> i) & 1;
        const bool committed_now = current && seq > st[0] && acks >= majority;
        const int32_t committed = committed_now ? seq : st[0];
        ns[0] = committed;
        ns[2] = mask;
        em[0].to(current && committed >= seq, CLIENT, K_COMMIT, committed);
        maybe_halt(em[1], p, committed, mask, st[3]);
        break;
      }
      case 4: {  // on_commit at the client: args = (seq,)
        const int32_t seq = c.args[0];
        const bool fresh = seq > st[0];
        if (fresh) ns[0] = seq;
        const bool done = seq >= p.writes;
        write(em[0], c, fresh && !done, seq + 1);
        em[1].to(fresh && done, PRIMARY, K_FIN);
        if constexpr (RECORD) {
          // close the pending write with its committed version, then
          // probe it with a READ through the primary (rseq = seq)
          rec[0].record(fresh, OP_WRITE, 0, seq, OK_OK);
          rec[1].record(fresh, OP_READ, 0, 0, OK_PENDING);
          em[2].to(fresh, PRIMARY, K_READ, seq);
          rec[2].record(fresh && !done, OP_WRITE, 0, seq + 1, OK_PENDING);
        }
        break;
      }
      case 5: {  // on_retx at the primary: args = (seq,)
        const int32_t seq = c.args[0];
        const bool current = seq == st[1];
        const bool pending_repl = current && st[2] != full_mask;
        // committed but the client may not know (lost COMMIT): re-ack
        const bool pending_commit = current && st[0] >= seq;
        replicate(em, seq, pending_repl, st[2], st);
        em[NR].to(pending_commit, CLIENT, K_COMMIT, st[0]);
        em[NR + 1].after(pending_repl || pending_commit, p.retx_ns, K_RETX,
                         PRIMARY, seq);
        break;
      }
      case 6: {  // on_cretx at the client: re-send what it waits on
        const bool waiting = st[0] < p.writes;
        write(em[0], c, waiting, st[0] + 1);
        em[1].to(!waiting, PRIMARY, K_FIN);
        em[2].after(true, p.client_retx_ns, K_CRETX, CLIENT);
        break;
      }
      case 7: {  // on_fin at the primary
        ns[3] = 1;
        maybe_halt(em[0], p, st[0], st[2], 1);
        break;
      }
      case 8: {  // on_join at the primary: args = (replica,)
        ns[2] = st[2] & ~(int32_t(1) << (c.args[0] - 1));
        // the planted lost-write fault: re-admitting a replica also
        // forgets the commit point
        if constexpr (BUG) ns[0] = 0;
        // the retx timer may have died while the mask was full: re-arm
        em[0].after(st[1] > 0, p.retx_ns, K_RETX, PRIMARY, st[1]);
        break;
      }
      case 9: {  // on_jretx at a replica: retry JOIN until synced
        const bool behind = st[0] == 0;
        em[0].to(behind, PRIMARY, K_JOIN, c.node);
        em[1].after(behind, p.retx_ns, K_JRETX, c.node);
        break;
      }
      case 10: {  // on_read at the primary: args = (rseq,)
        em[0].to(true, CLIENT, K_READRESP, c.args[0], st[0]);
        break;
      }
      default: {  // 11, on_readresp at the client: args = (rseq, committed)
        // stale-rseq gate: only in-invoke-order responses count
        const bool fresh_r = c.args[0] > st[1];
        if (fresh_r) ns[1] = c.args[0];
        if constexpr (RECORD) rec[0].record(fresh_r, OP_READ, 0, c.args[1], OK_OK);
        break;
      }
    }
  }
};

}  // namespace madsim
