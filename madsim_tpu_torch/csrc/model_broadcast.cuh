// Reliable broadcast under a random link partition
// (madsim_tpu_torch/models/broadcast.py) as a model trait of the run
// kernel (engine_step.cuh): N_ nodes (n_nodes, five by default), four
// handlers, and an init that emits the engine's CLOG/UNCLOG rows.
// PARTITION = false (partition=False) schedules no partition and draws
// nothing. BroadcastModel is the factory's default variant.
#pragma once

#include "engine_step.cuh"

namespace madsim {

template <int N_ = 5, bool PARTITION = true>
struct BroadcastModelT {
  static_assert(N_ >= 2 && N_ <= 32, "the ack mask holds every peer");
  static constexpr int N = N_, U = 4, A = 2, W = 0, H = 4;
  static constexpr int K = N + 2 > 6 ? N + 2 : 6;  // max(peers + 3, 6)
  static constexpr int R = 0;  // records nothing
  static constexpr int32_t n_peers = N - 1;
  static constexpr int32_t full_mask = (1 << n_peers) - 1;

  struct Params {
    int32_t rounds;
    int64_t retx_ns;
  };
  static Params params(const int64_t* w) {
    return Params{static_cast<int32_t>(w[0]), w[1]};
  }

  static constexpr int32_t ORIGIN = 0;
  static constexpr int32_t K_MSG = FIRST_USER_KIND + 1;
  static constexpr int32_t K_ACK = FIRST_USER_KIND + 2;
  static constexpr int32_t K_RETX = FIRST_USER_KIND + 3;
  static constexpr uint32_t P_CHAOS_LINK = 1, P_CHAOS_AT = 2, P_CHAOS_LEN = 3;

  // rows 0..N-2: seq to every peer
  static MADSIM_HDI void bcast(Emit<A, W>* em, int32_t seq, bool when) {
    for (int32_t q = 1; q < N; q++) em[q - 1].to(when, q, K_MSG, seq);
  }

  static MADSIM_HD void handle(int32_t h, const Ctx<BroadcastModelT>& c,
                               const Params& p, int32_t* ns,
                               Emit<A, W>* em, Rec*) {
    const int32_t* st = c.state;
    switch (h) {
      case 0: {  // on_init: the origin starts round 1 and the partition
        const bool is_origin = c.node == ORIGIN;
        bcast(em, 1, is_origin);
        em[n_peers].after(is_origin, p.retx_ns, K_RETX, ORIGIN, 1);
        if (is_origin) {
          if constexpr (PARTITION) {
            const int64_t a = c.user_int(1, N, P_CHAOS_LINK);
            const int64_t b_raw = c.user_int(1, N - 1, P_CHAOS_LINK + 16);
            const int64_t b = b_raw >= a ? b_raw + 1 : b_raw;
            const int64_t at = c.user_int(0, 100000000, P_CHAOS_AT);
            const int64_t len = c.user_int(50000000, 400000000, P_CHAOS_LEN);
            em[n_peers + 1].after(true, at, KIND_CLOG, 0,
                                  static_cast<int32_t>(a), static_cast<int32_t>(b));
            em[n_peers + 2].after(true, at + len, KIND_UNCLOG, 0,
                                  static_cast<int32_t>(a), static_cast<int32_t>(b));
          }
          ns[0] = 1;
        }
        break;
      }
      case 1: {  // on_msg at a receiver: args = (seq,)
        const int32_t seq = c.args[0];
        ns[0] = st[0] > seq ? st[0] : seq;
        ns[1] = st[1] + 1;
        // always ack (idempotent) so lost acks are re-covered by retx
        em[0].to(true, ORIGIN, K_ACK, seq, c.node);
        break;
      }
      case 2: {  // on_ack at the origin: args = (seq, peer)
        const int32_t seq = c.args[0], peer = c.args[1];
        const int32_t cur = st[0];
        int32_t mask = st[1];
        if (seq == cur) mask |= int32_t(1) << (peer - 1);
        const bool complete = mask == full_mask;
        const bool last_round = cur >= p.rounds;
        const bool advance = complete && !last_round;
        const int32_t nxt = advance ? cur + 1 : cur;
        bcast(em, nxt, advance);
        em[n_peers].after(advance, p.retx_ns, K_RETX, ORIGIN, nxt);
        em[n_peers + 1].after(complete && last_round, 0, KIND_HALT, 0);
        ns[0] = nxt;
        ns[1] = advance ? 0 : mask;
        break;
      }
      default: {  // 3, on_retx at the origin: args = (seq,)
        const int32_t cur = st[0], mask = st[1];
        const bool pending = c.args[0] == cur && mask != full_mask;
        for (int32_t i = 0; i < n_peers; i++)
          em[i].to(pending && ((mask >> i) & 1) == 0, i + 1, K_MSG, cur);
        em[n_peers].after(pending, p.retx_ns, K_RETX, ORIGIN, cur);
        break;
      }
    }
  }
};

using BroadcastModel = BroadcastModelT<>;

}  // namespace madsim
