// Single-decree Paxos with dueling proposers and proposer-crash chaos
// (madsim_tpu_torch/models/paxos.py) as a model trait of the run kernel
// (engine_step.cuh): NA_ acceptors and NP_ proposers (n_acceptors and
// n_proposers, five and three by default), eight handlers, three args
// words. PROMISE, ACCEPTED and NACK go back to
// the event's sender (Ctx::src); a NACK fast-forwards the proposer's
// round to floor(ballot / P) + 1. PaxosModel<true> is the record
// variant (paxos-record): a decision reached or first adopted appends an
// OP_DECIDE history record. CHAOS = false (chaos=False, for fault
// plans) drops acceptor 0's kill and restart of a proposer. DURACC is
// durable_acceptors=True: the kill aims at one of acceptors 1..NA-1, and
// the acceptor columns surviving its restart are the workload's
// volatile mask, a table of the kernel's (engine/fused.py _tables).
#pragma once

#include "engine_step.cuh"

namespace madsim {

template <bool RECORD = false, bool CHAOS = true, bool DURACC = false, int NA_ = 5,
          int NP_ = 3>
struct PaxosModel {
  static_assert(NA_ >= 1 && NP_ >= 1, "a ballot needs an acceptor and a proposer");
  static_assert(!DURACC || NA_ >= 2, "the kill aims at acceptors 1..NA-1");
  static constexpr int NA = NA_, NP = NP_;  // acceptors, proposers
  // on_propose's NA + 2 rows, on_accepted's NP + 1, init's 3
  static constexpr int K0 = NA + 2 > NP + 1 ? NA + 2 : NP + 1;
  static constexpr int N = NA + NP, U = 10, A = 3, W = 0, K = K0 > 3 ? K0 : 3, H = 8;
  static constexpr int R = RECORD ? 1 : 0;  // history records per call
  static constexpr int32_t OP_DECIDE = OP_USER;
  static constexpr int32_t majority = NA / 2 + 1;

  struct Params {
    int64_t start_min, start_max, timeout_min, timeout_max;
    int64_t kill_min, kill_max, revive_min, revive_max;
  };
  // words: start_min_ns, start_max_ns, timeout_min_ns, timeout_max_ns,
  // kill_min_ns, kill_max_ns, revive_min_ns, revive_max_ns
  static Params params(const int64_t* w) {
    return Params{w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7]};
  }

  // acceptor columns
  static constexpr int32_t A_PROM = 0, A_BAL = 1, A_VAL = 2;
  // proposer columns
  static constexpr int32_t PHASE = 0, BAL = 1, VAL = 2, PCNT = 3, BESTB = 4,
                           BESTV = 5, ACNT = 6, DEC = 7, ROUND = 8, TSEQ = 9;
  static constexpr int32_t IDLE = 0, PREPARING = 1, ACCEPTING = 2, DONE = 3;
  static constexpr int32_t K_PROPOSE = FIRST_USER_KIND + 1;
  static constexpr int32_t K_PREPARE = FIRST_USER_KIND + 2;
  static constexpr int32_t K_PROMISE = FIRST_USER_KIND + 3;
  static constexpr int32_t K_ACCEPT = FIRST_USER_KIND + 4;
  static constexpr int32_t K_ACCEPTED = FIRST_USER_KIND + 5;
  static constexpr int32_t K_DECIDED = FIRST_USER_KIND + 6;
  static constexpr int32_t K_NACK = FIRST_USER_KIND + 7;
  static constexpr uint32_t P_START = 0, P_TIMEOUT = 1, P_KILL_AT = 2,
                            P_KILL_WHO = 3, P_REVIVE = 4;

  using Em = Emit<A, W>;
  using C = Ctx<PaxosModel>;

  // a PROPOSE timer row (args = tseq), drawn only when it is valid
  static MADSIM_HDI void arm(Em& e, const C& c, int32_t tseq, bool when,
                             int64_t lo, int64_t hi, uint32_t purpose) {
    e.after(when, when ? c.user_int(lo, hi, purpose) : 0, K_PROPOSE, c.node, tseq);
  }

  static MADSIM_HD void handle(int32_t h, const C& c, const Params& p,
                               int32_t* ns, Em* em, [[maybe_unused]] Rec* rec) {
    const int32_t* st = c.state;
    const bool is_prop = c.node >= NA;
    switch (h) {
      case 0: {  // on_init
        arm(em[0], c, 1, is_prop, p.start_min, p.start_max, P_START);
        // acceptor 0's t=0 init schedules the seed's kill and restart of
        // one proposer (a reborn proposer re-runs on_init at now > 0)
        if (CHAOS && c.node == 0 && c.now == 0) {
          const int32_t who =
              DURACC ? 1 + static_cast<int32_t>(c.user_int(0, NA - 1, P_KILL_WHO))
                     : NA + static_cast<int32_t>(c.user_int(0, NP, P_KILL_WHO));
          const int64_t at = c.user_int(p.kill_min, p.kill_max, P_KILL_AT);
          const int64_t revive = c.user_int(p.revive_min, p.revive_max, P_REVIVE);
          em[1].after(true, at, KIND_KILL, 0, who);
          em[2].after(true, at + revive, KIND_RESTART, 0, who);
        }
        if (is_prop) ns[TSEQ] = 1;
        break;
      }
      case 1: {  // on_propose, the timer at a proposer: args = (tseq,)
        const bool live = c.args[0] == st[TSEQ] && is_prop;
        const bool fire = live && st[DEC] == 0;
        // a decided proposer keeps re-delivering DECIDED to the witness
        const bool redeliver = live && st[DEC] != 0;
        const int32_t ballot = st[ROUND] * NP + (c.node - NA) + 1;
        if (fire) {
          ns[PHASE] = PREPARING;
          ns[BAL] = ballot;
          ns[PCNT] = 0;
          ns[BESTB] = 0;
          ns[BESTV] = 0;
          ns[ACNT] = 0;
          ns[ROUND] = st[ROUND] + 1;
        }
        if (live) ns[TSEQ] = st[TSEQ] + 1;
        em[0].to(redeliver, 0, K_DECIDED, st[DEC]);
        for (int32_t acc = 0; acc < NA; acc++) em[1 + acc].to(fire, acc, K_PREPARE, ballot);
        arm(em[NA + 1], c, st[TSEQ] + 1, live, p.timeout_min, p.timeout_max, P_TIMEOUT);
        break;
      }
      case 2: {  // on_prepare at an acceptor: args = (ballot,)
        const int32_t b = c.args[0];
        const bool grant = b > st[A_PROM];
        if (grant) ns[A_PROM] = b;
        em[0].to(grant, c.src, K_PROMISE, b, st[A_BAL]);
        em[0].args[2] = st[A_VAL];
        em[1].to(!grant, c.src, K_NACK, st[A_PROM]);
        break;
      }
      case 3: {  // on_promise at a proposer: args = (ballot, acc_bal, acc_val)
        const int32_t b = c.args[0], abal = c.args[1], aval = c.args[2];
        const bool relevant = st[PHASE] == PREPARING && b == st[BAL];
        const int32_t pcnt = relevant ? st[PCNT] + 1 : st[PCNT];
        const bool better = relevant && abal > st[BESTB];
        const int32_t bestb = better ? abal : st[BESTB];
        const int32_t bestv = better ? aval : st[BESTV];
        const bool won = relevant && pcnt >= majority;
        // adopt the highest-ballot accepted value heard, else our own
        const int32_t value = bestb > 0 ? bestv : c.node - NA + 1;
        ns[PCNT] = pcnt;
        ns[BESTB] = bestb;
        ns[BESTV] = bestv;
        if (won) {
          ns[PHASE] = ACCEPTING;
          ns[VAL] = value;
          ns[ACNT] = 0;
        }
        for (int32_t acc = 0; acc < NA; acc++) em[acc].to(won, acc, K_ACCEPT, b, value);
        break;
      }
      case 4: {  // on_accept at an acceptor: args = (ballot, value)
        const int32_t b = c.args[0], v = c.args[1];
        const bool ok = b >= st[A_PROM];
        if (ok) {
          ns[A_PROM] = b;
          ns[A_BAL] = b;
          ns[A_VAL] = v;
        }
        em[0].to(ok, c.src, K_ACCEPTED, b);
        em[1].to(!ok, c.src, K_NACK, st[A_PROM]);
        break;
      }
      case 5: {  // on_accepted at a proposer: args = (ballot,)
        const int32_t b = c.args[0];
        const bool relevant = st[PHASE] == ACCEPTING && b == st[BAL];
        const int32_t acnt = relevant ? st[ACNT] + 1 : st[ACNT];
        const bool chosen = relevant && acnt >= majority;
        ns[ACNT] = acnt;
        if (chosen) {
          ns[PHASE] = DONE;
          ns[DEC] = st[VAL];
        }
        for (int32_t i = 0; i < NP; i++)
          em[i].to(chosen && NA + i != c.node, NA + i, K_DECIDED, st[VAL]);
        // acceptor 0 is the halt witness
        em[NP].to(chosen, 0, K_DECIDED, st[VAL]);
        if constexpr (RECORD) rec[0].record(chosen, OP_DECIDE, 0, st[VAL], OK_OK);
        break;
      }
      case 6: {  // on_decided: args = (value,)
        if (is_prop) {
          if (st[DEC] == 0) ns[DEC] = c.args[0];
          ns[PHASE] = DONE;
        }
        em[0].after(c.node == 0, 0, KIND_HALT, 0);
        // first adoption only: what this proposer now believes
        if constexpr (RECORD)
          rec[0].record(is_prop && st[DEC] == 0, OP_DECIDE, 0, c.args[0], OK_OK);
        break;
      }
      default: {  // 7, on_nack at a proposer: args = (promised,)
        const int32_t b = c.args[0];
        // a higher ballot kills this round: abandon it and fast-forward
        if (is_prop && b > st[BAL] && st[DEC] == 0) {
          const int32_t ffwd = floordiv(b, NP) + 1;
          ns[PHASE] = IDLE;
          ns[ROUND] = st[ROUND] > ffwd ? st[ROUND] : ffwd;
        }
        break;
      }
    }
  }
};

}  // namespace madsim
