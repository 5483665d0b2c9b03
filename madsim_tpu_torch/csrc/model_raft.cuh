// Raft leader election (madsim_tpu_torch/models/raft.py) as a model
// trait of the run kernel (engine_step.cuh): N_ nodes (n_nodes, five by
// default), five handlers. RaftModel<true> is the record variant
// (raft-election-record): each election win appends an OP_ELECT history
// record.
#pragma once

#include "engine_step.cuh"

namespace madsim {

template <bool RECORD, int N_ = 5>
struct RaftModel {
  static_assert(N_ >= 1, "a cluster has a node");
  static constexpr int N = N_;     // nodes
  static constexpr int U = 6;      // state row width
  static constexpr int A = 2;      // event args words
  static constexpr int W = 0;      // payload words
  static constexpr int K = N + 1;  // emit slots per handler
  static constexpr int H = 5;      // handlers
  static constexpr int R = RECORD ? 1 : 0;  // history records per call
  static constexpr int32_t OP_ELECT = OP_USER;

  // the factory's election timeout range
  struct Params {
    int64_t timeout_min;
    uint32_t timeout_span;
  };
  static Params params(const int64_t* w) {
    return Params{w[0], draw_span(w[0], w[1])};
  }

  static constexpr int32_t ROLE = 0, TERM = 1, VOTED = 2, VOTES = 3, TSEQ = 4;
  static constexpr int32_t FOLLOWER = 0, CANDIDATE = 1, LEADER = 2;
  static constexpr int32_t K_TIMEOUT = FIRST_USER_KIND + 1;
  static constexpr int32_t K_REQVOTE = FIRST_USER_KIND + 2;
  static constexpr int32_t K_GRANT = FIRST_USER_KIND + 3;
  static constexpr int32_t K_HEARTBEAT = FIRST_USER_KIND + 4;

  // the election timeout draw: user purpose 0, drawn only when its
  // timer row is valid (an invalid row's delay is never read)
  static MADSIM_HDI int64_t timeout(const Ctx<RaftModel>& c, const Params& p) {
    return p.timeout_min + static_cast<int64_t>(c.user(0) % p.timeout_span);
  }

  static MADSIM_HD void handle(int32_t h, const Ctx<RaftModel>& c,
                               const Params& p, int32_t* ns,
                               Emit<A, W>* em, [[maybe_unused]] Rec* rec) {
    constexpr int32_t majority = N / 2 + 1;
    const int32_t* st = c.state;
    const int32_t node = c.node;
    switch (h) {
      case 0: {  // on_init
        em[0].after(true, timeout(c, p), K_TIMEOUT, node, 1);
        ns[TSEQ] = 1;
        break;
      }
      case 1: {  // on_timeout: args = (timeout_seq,)
        const bool fire = c.args[0] == st[TSEQ] && st[ROLE] != LEADER;
        const int32_t term = st[TERM] + 1;
        if (fire) {
          ns[ROLE] = CANDIDATE;
          ns[TERM] = term;
          ns[VOTED] = term;
          ns[VOTES] = 1;
          ns[TSEQ] = st[TSEQ] + 1;
        }
        for (int32_t q = 0; q < N; q++)
          em[q].to(fire && q != node, q, K_REQVOTE, term, node);
        em[N].after(fire, fire ? timeout(c, p) : 0, K_TIMEOUT, node,
                    st[TSEQ] + 1);
        break;
      }
      case 2: {  // on_reqvote: args = (term, candidate)
        const int32_t term = c.args[0], cand = c.args[1];
        int32_t st1[U];
        for (int u = 0; u < U; u++) st1[u] = st[u];
        if (term > st[TERM]) {  // step down on a newer term
          st1[TERM] = term;
          st1[ROLE] = FOLLOWER;
          st1[VOTES] = 0;
        }
        const bool grant = term == st1[TERM] && st1[VOTED] < term;
        for (int u = 0; u < U; u++) ns[u] = st1[u];
        if (grant) {
          ns[VOTED] = term;
          ns[TSEQ] = st1[TSEQ] + 1;
        }
        em[0].to(grant, cand, K_GRANT, term);
        // granting resets the election timer (vote then wait)
        em[1].after(grant, grant ? timeout(c, p) : 0, K_TIMEOUT, node,
                    st1[TSEQ] + 1);
        break;
      }
      case 3: {  // on_grant: args = (term,)
        const int32_t term = c.args[0];
        const bool counts = st[ROLE] == CANDIDATE && term == st[TERM];
        const int32_t votes = counts ? st[VOTES] + 1 : st[VOTES];
        const bool wins = counts && votes >= majority;
        ns[VOTES] = votes;
        if (wins) ns[ROLE] = LEADER;
        for (int32_t q = 0; q < N; q++)
          em[q].to(wins && q != node, q, K_HEARTBEAT, term);
        // leader elected: scenario complete
        em[N].after(wins, 0, KIND_HALT, 0);
        if constexpr (RECORD) rec[0].record(wins, OP_ELECT, term, node, OK_OK);
        break;
      }
      default: {  // 4, on_heartbeat: args = (term,)
        const int32_t term = c.args[0];
        const bool accept = term >= st[TERM];
        if (accept) {
          ns[TERM] = term;
          ns[ROLE] = FOLLOWER;
          ns[TSEQ] = st[TSEQ] + 1;
        }
        em[0].after(accept, accept ? timeout(c, p) : 0, K_TIMEOUT, node,
                    st[TSEQ] + 1);
        break;
      }
    }
  }
};

}  // namespace madsim
