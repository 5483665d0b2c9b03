// Ping-pong RPC (madsim_tpu_torch/models/pingpong.py) as a model trait
// of the run kernel (engine_step.cuh): a server (node 0) and NC clients
// (n_clients, two by default), four handlers; PingpongModel is the
// default variant.
#pragma once

#include "engine_step.cuh"

namespace madsim {

template <int NC = 2>
struct PingpongModelT {
  static_assert(NC >= 1, "a client pings");
  static constexpr int N = 1 + NC, U = 4, A = 2, W = 0, K = 2, H = 4;
  static constexpr int R = 0;  // records nothing
  static constexpr int32_t n_clients = NC;

  struct Params {
    int32_t rounds;
  };
  static Params params(const int64_t* w) {
    return Params{static_cast<int32_t>(w[0])};
  }

  static constexpr int32_t SERVER = 0;
  static constexpr int32_t K_PING = FIRST_USER_KIND + 1;
  static constexpr int32_t K_PONG = FIRST_USER_KIND + 2;
  static constexpr int32_t K_DONE = FIRST_USER_KIND + 3;

  static MADSIM_HD void handle(int32_t h, const Ctx<PingpongModelT>& c,
                               const Params& p, int32_t* ns,
                               Emit<A, W>* em, Rec*) {
    const int32_t* st = c.state;
    switch (h) {
      case 0:  // on_init: each client sends its first ping
        em[0].to(c.node != SERVER, SERVER, K_PING, 0, c.node);
        break;
      case 1:  // on_ping at the server: args = (seq, client)
        ns[1] = st[1] + 1;
        em[0].to(true, c.args[1], K_PONG, c.args[0]);
        break;
      case 2: {  // on_pong at a client: args = (seq,)
        const int32_t seq = c.args[0] + 1;
        ns[0] = seq;
        const bool done = seq >= p.rounds;
        em[0].to(!done, SERVER, K_PING, seq, c.node);
        em[1].to(done, SERVER, K_DONE);
        break;
      }
      default: {  // 3, on_done at the server
        const int32_t finished = st[0] + 1;
        ns[0] = finished;
        em[0].after(finished >= n_clients, 0, KIND_HALT, 0);
        break;
      }
    }
  }
};

using PingpongModel = PingpongModelT<>;

}  // namespace madsim
