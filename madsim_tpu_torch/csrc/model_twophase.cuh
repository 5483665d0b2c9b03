// Two-phase commit under chaos (madsim_tpu_torch/models/twophase.py,
// default variant) as a model trait of the run kernel (engine_step.cuh):
// a coordinator and P_ participants (n_parts, four by default), nine
// handlers, three args words and max(2P + 1, P + 6) emits. The retransmit handler fills the per-participant
// PREPARE rows 0..P-1 and DECISION rows P..2P-1 whatever the phase, so
// each row index keys the same latency draw as the plain step's
// EmitBuilder; the engine places the valid ones compactly. As in every
// trait, `default` is the last handler: nvcc 12.8 built a switch whose
// `default` stood for handler 7, between the cases 6 and 8 (on_hello
// and on_resync, sharing a body), so that handler 7 ran that body on
// the card, where g++ ran it right. TwoPhaseModel<true> is the record
// variant (twophase-record): every decision taken or adopted appends an
// OP_DECIDE history record. CHAOS = false (chaos=False, for fault
// plans) drops the coordinator's kill, restart and resync rows.
#pragma once

#include "engine_step.cuh"

namespace madsim {

template <bool RECORD = false, bool CHAOS = true, int P_ = 4>
struct TwoPhaseModel {
  static_assert(P_ >= 1 && P_ <= 30, "the vote and ack masks hold every participant");
  static constexpr int P = P_;  // participants
  // the retransmit's 2P + 1 rows, or init's P + 6 (the chaos rows last)
  static constexpr int K = 2 * P + 1 > P + 6 ? 2 * P + 1 : P + 6;
  static constexpr int N = 1 + P, U = 6, A = 3, W = 0, H = 9;
  static constexpr int R = RECORD ? 1 : 0;  // history records per call
  static constexpr int32_t OP_DECIDE = OP_USER;
  static constexpr int32_t COORD = 0;
  static constexpr int32_t full_mask = (1 << P) - 1;

  struct Params {
    int32_t txns, no_pct;
    int64_t retx_ns, revive_min, revive_max;
  };
  // words: txns, no_pct, retx_ns, revive_min_ns, revive_max_ns
  static Params params(const int64_t* w) {
    return Params{static_cast<int32_t>(w[0]), static_cast<int32_t>(w[1]), w[2],
                  w[3], w[4]};
  }

  static constexpr int32_t K_PREPARE = FIRST_USER_KIND + 1;
  static constexpr int32_t K_VOTE = FIRST_USER_KIND + 2;
  static constexpr int32_t K_DECISION = FIRST_USER_KIND + 3;
  static constexpr int32_t K_ACK = FIRST_USER_KIND + 4;
  static constexpr int32_t K_RETX = FIRST_USER_KIND + 5;
  static constexpr int32_t K_HELLO = FIRST_USER_KIND + 6;
  static constexpr int32_t K_HRETX = FIRST_USER_KIND + 7;
  static constexpr int32_t K_RESYNC = FIRST_USER_KIND + 8;
  static constexpr uint32_t P_VOTE = 0, P_KILL_AT = 1, P_KILL_WHO = 2, P_REVIVE = 3;

  using Em = Emit<A, W>;
  using C = Ctx<TwoPhaseModel>;

  // rows 0..P-1: one message to each participant whose bit in `skip`
  // is clear
  static MADSIM_HDI void bcast(Em* em, int32_t kind, int32_t txn, int32_t a1,
                               bool when, int32_t skip) {
    for (int32_t i = 0; i < P; i++)
      em[i].to(when && ((skip >> i) & 1) == 0, i + 1, kind, txn, a1);
  }

  // on_hello (6, lossy) and on_resync (8, loss-free): the reborn
  // participant args[0] lost its RAM, so its bit for the current
  // transaction is cleared and the retransmit loop re-covers it
  static MADSIM_HDI void clear_bit(const C& c, int32_t* ns) {
    const int32_t* st = c.state;
    const int32_t bit = int32_t(1) << (c.args[0] - 1);
    if (st[1] == 0) {
      ns[2] = st[2] & ~bit;
    } else {
      ns[3] = st[3] & ~bit;
    }
  }

  static MADSIM_HD void handle(int32_t h, const C& c, const Params& p,
                               int32_t* ns, Em* em, [[maybe_unused]] Rec* rec) {
    const int32_t* st = c.state;
    switch (h) {
      case 0: {  // on_init
        const bool is_coord = c.node == COORD;
        bcast(em, K_PREPARE, 1, 0, is_coord, 0);
        em[P].after(is_coord, p.retx_ns, K_RETX, COORD, 1);
        // a (re)born participant announces itself, retried by a timer
        em[P + 1].to(!is_coord, COORD, K_HELLO, c.node);
        em[P + 2].after(!is_coord, p.retx_ns, K_HRETX, c.node);
        if (is_coord) {
          if constexpr (CHAOS) {  // the seed's chaos schedule
            const int32_t who = static_cast<int32_t>(c.user_int(1, N, P_KILL_WHO));
            const int64_t at = c.user_int(20000000, 250000000, P_KILL_AT);
            const int64_t revive = c.user_int(p.revive_min, p.revive_max, P_REVIVE);
            em[P + 3].after(true, at, KIND_KILL, 0, who);
            em[P + 4].after(true, at + revive, KIND_RESTART, 0, who);
            // the loss-free local resync at the revive time
            em[P + 5].after(true, at + revive, K_RESYNC, COORD, who);
          }
          ns[0] = 1;
        }
        break;
      }
      case 1: {  // on_prepare at a participant: args = (txn,)
        const int32_t txn = c.args[0];
        // the vote is drawn once, at first receipt, and stored
        const int32_t vote =
            txn > st[0] ? (c.user_int(0, 100, P_VOTE) >= p.no_pct ? 1 : 0) : st[1];
        ns[0] = st[0] > txn ? st[0] : txn;
        ns[1] = vote;
        em[0].to(true, COORD, K_VOTE, txn, c.node);
        em[0].args[2] = vote;
        break;
      }
      case 2: {  // on_vote at the coordinator: args = (txn, part, yes)
        const int32_t txn = c.args[0], who = c.args[1], yes = c.args[2];
        const bool relevant = txn == st[0] && st[1] == 0;
        const int32_t votes = relevant ? (st[2] | (int32_t(1) << (who - 1))) : st[2];
        const bool abort_now = relevant && yes == 0;
        const bool commit_now = relevant && yes != 0 && votes == full_mask;
        const bool decide = abort_now || commit_now;
        const int32_t phase = decide ? (abort_now ? 2 : 1) : st[1];
        ns[1] = phase;
        ns[2] = votes;
        if (decide) ns[3] = 0;
        bcast(em, K_DECISION, txn, phase == 1 ? 1 : 0, decide, 0);
        if constexpr (RECORD)
          rec[0].record(decide, OP_DECIDE, txn, phase == 1 ? 1 : 0, OK_OK);
        break;
      }
      case 3: {  // on_decision at a participant: args = (txn, commit)
        const int32_t txn = c.args[0], commit = c.args[1];
        const bool fresh = txn > st[2];
        ns[2] = st[2] > txn ? st[2] : txn;
        ns[3] = st[3] + (fresh ? 1 : 0);
        if (fresh) ns[4] = commit;  // the decision VALUE, for agreement
        em[0].to(true, COORD, K_ACK, txn, c.node);
        if constexpr (RECORD) rec[0].record(fresh, OP_DECIDE, txn, commit, OK_OK);
        break;
      }
      case 4: {  // on_ack at the coordinator: args = (txn, part)
        const int32_t txn = c.args[0], who = c.args[1];
        const bool relevant = txn == st[0] && st[1] >= 1;
        const int32_t acks = relevant ? (st[3] | (int32_t(1) << (who - 1))) : st[3];
        const bool complete = relevant && acks == full_mask;
        const bool committed = st[1] == 1;
        const bool last = st[0] >= p.txns;
        const bool advance = complete && !last;
        const int32_t nxt = advance ? st[0] + 1 : st[0];
        ns[0] = nxt;
        if (advance) {
          ns[1] = 0;
          ns[2] = 0;
        }
        ns[3] = acks;
        ns[4] = st[4] + ((complete && committed) ? 1 : 0);
        ns[5] = st[5] + ((complete && !committed) ? 1 : 0);
        bcast(em, K_PREPARE, nxt, 0, advance, 0);
        em[P].after(advance, p.retx_ns, K_RETX, COORD, nxt);
        em[P + 1].after(complete && last, 0, KIND_HALT, 0);
        break;
      }
      case 5: {  // on_retx at the coordinator: args = (txn,)
        const int32_t txn = c.args[0];
        const bool current = txn == st[0];
        // missing votes: re-PREPARE (rows 0..P-1); missing acks:
        // re-DECISION (rows P..2P-1)
        bcast(em, K_PREPARE, txn, 0, current && st[1] == 0, st[2]);
        bcast(em + P, K_DECISION, txn, st[1] == 1 ? 1 : 0, current && st[1] >= 1,
              st[3]);
        em[2 * P].after(current, p.retx_ns, K_RETX, COORD, txn);
        break;
      }
      case 6: {  // on_hello at the coordinator: args = (part,)
        clear_bit(c, ns);
        break;
      }
      case 7: {  // on_hretx at a participant
        // retry until any traffic seen (a prepare or a decision)
        const bool unseen = st[0] == 0 && st[2] == 0;
        em[0].to(unseen, COORD, K_HELLO, c.node);
        em[1].after(unseen, p.retx_ns, K_HRETX, c.node);
        break;
      }
      default: {  // 8, on_resync at the coordinator: args = (part,)
        clear_bit(c, ns);
        break;
      }
    }
  }
};

}  // namespace madsim
