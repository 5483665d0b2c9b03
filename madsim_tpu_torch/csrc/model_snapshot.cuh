// Lai-Yang distributed snapshot over a money-transfer workload
// (madsim_tpu_torch/models/snapshot.py) as a model trait of the run
// kernel (engine_step.cuh): N_ nodes (n_nodes, five by default), five
// handlers; SnapshotModel is the default variant. A node turning
// red paints every peer with a zero-amount red transfer; the paint rows
// keep the self row, never valid, so that each row index keys the same
// latency draw as the plain step's EmitBuilder.
#pragma once

#include "engine_step.cuh"

namespace madsim {

template <int N_ = 5>
struct SnapshotModelT {
  static_assert(N_ >= 2, "a transfer needs a peer");
  static constexpr int N = N_, U = 6, A = 2, W = 0, K = N + 1, H = 5;
  static constexpr int R = 0;  // records nothing

  struct Params {
    int32_t n_sends, balance, amount_max, total_msgs;
    int64_t send_min, send_max, snap_min, snap_max;
  };
  // words: n_sends, balance, amount_max, send_min_ns, send_max_ns,
  // snap_min_ns, snap_max_ns
  static Params params(const int64_t* w) {
    const int32_t n_sends = static_cast<int32_t>(w[0]);
    return Params{n_sends, static_cast<int32_t>(w[1]), static_cast<int32_t>(w[2]),
                  N * n_sends + N * (N - 1), w[3], w[4], w[5], w[6]};
  }

  static constexpr int32_t COLOR = 0, BAL = 1, RECBAL = 2, CHANIN = 3,
                           SENT = 4, RCNT = 5;
  static constexpr int32_t K_SEND = FIRST_USER_KIND + 1;
  static constexpr int32_t K_TRANSFER = FIRST_USER_KIND + 2;
  static constexpr int32_t K_SNAP = FIRST_USER_KIND + 3;
  static constexpr int32_t K_RECVD = FIRST_USER_KIND + 4;
  static constexpr uint32_t P_SEND = 0, P_DST = 1, P_AMT = 2, P_SNAP = 3;

  using Em = Emit<A, W>;
  using C = Ctx<SnapshotModelT>;

  // the next transfer timer (user purpose 0), drawn only when valid
  static MADSIM_HDI void arm_send(Em& e, const C& c, const Params& p, bool when) {
    e.after(when, when ? c.user_int(p.send_min, p.send_max, P_SEND) : 0, K_SEND,
            c.node);
  }

  // rows 0..N-1: a zero-amount red transfer to every peer
  static MADSIM_HDI void paints(Em* em, const C& c, bool when) {
    for (int32_t q = 0; q < N; q++) em[q].to(when && q != c.node, q, K_TRANSFER, 0, 1);
  }

  static MADSIM_HD void handle(int32_t h, const C& c, const Params& p,
                               int32_t* ns, Em* em, Rec*) {
    const int32_t* st = c.state;
    switch (h) {
      case 0: {  // on_init
        arm_send(em[0], c, p, true);
        const bool initiator = c.node == 0;
        em[1].after(initiator,
                    initiator ? c.user_int(p.snap_min, p.snap_max, P_SNAP) : 0,
                    K_SNAP, c.node);
        ns[BAL] = p.balance;
        break;
      }
      case 1: {  // on_send: the transfer timer
        if (st[SENT] < p.n_sends) {
          const int64_t r = c.user_int(0, N - 1, P_DST);
          const int32_t dst = static_cast<int32_t>((c.node + 1 + r) % N);  // never self
          const int32_t amt = static_cast<int32_t>(c.user_int(1, p.amount_max + 1, P_AMT));
          ns[BAL] = st[BAL] - amt;
          ns[SENT] = st[SENT] + 1;
          em[0].to(true, dst, K_TRANSFER, amt, st[COLOR]);
          arm_send(em[1], c, p, st[SENT] + 1 < p.n_sends);
        }
        break;
      }
      case 2: {  // on_transfer: args = (amount, sender_color)
        const int32_t amt = c.args[0];
        const bool msg_red = c.args[1] == 1;
        const bool was_white = st[COLOR] == 0;
        const bool turn = was_white && msg_red;
        // Lai-Yang: record BEFORE applying a first red message; a white
        // arrival at a red node is channel state; always apply
        if (turn) {
          ns[COLOR] = 1;
          ns[RECBAL] = st[BAL];
        }
        if (!was_white && !msg_red) ns[CHANIN] = st[CHANIN] + amt;
        ns[BAL] = st[BAL] + amt;
        paints(em, c, turn);
        em[N].to(true, 0, K_RECVD);
        break;
      }
      case 3: {  // on_snap: the initiator turns red
        const bool turn = st[COLOR] == 0;
        if (turn) {
          ns[COLOR] = 1;
          ns[RECBAL] = st[BAL];
        }
        paints(em, c, turn);
        break;
      }
      default: {  // 4, on_recvd: the witness count at node 0
        const int32_t cnt = st[RCNT] + 1;
        ns[RCNT] = cnt;
        em[0].after(cnt == p.total_msgs, 0, KIND_HALT, 0);
        break;
      }
    }
  }
};

using SnapshotModel = SnapshotModelT<>;

}  // namespace madsim
