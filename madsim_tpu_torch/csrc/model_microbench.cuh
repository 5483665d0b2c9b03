// Single-node timer + RNG microbenchmark
// (madsim_tpu_torch/models/microbench.py) as a model trait of the run
// kernel (engine_step.cuh): no network, two handlers.
#pragma once

#include "engine_step.cuh"

namespace madsim {

struct MicrobenchModel {
  static constexpr int N = 1, U = 4, A = 2, W = 0, K = 2, H = 2;
  static constexpr int R = 0;  // records nothing

  struct Params {
    int32_t rounds;
    int64_t delay_min, delay_max;
  };
  static Params params(const int64_t* w) {
    return Params{static_cast<int32_t>(w[0]), w[1], w[2]};
  }

  static constexpr int32_t K_TICK = FIRST_USER_KIND + 1;
  static constexpr uint32_t P_DELAY = 0, P_VALUE = 1;

  static MADSIM_HD void handle(int32_t h, const Ctx<MicrobenchModel>& c,
                               const Params& p, int32_t* ns,
                               Emit<A, W>* em, Rec*) {
    if (h == 0) {  // on_init
      em[0].after(true, c.user_int(p.delay_min, p.delay_max, P_DELAY), K_TICK,
                  c.node);
      return;
    }
    // 1, on_tick: count, fold a draw, sleep again or halt
    const int32_t count = c.state[0] + 1;
    ns[0] = count;
    ns[1] = c.state[1] ^ static_cast<int32_t>(c.user(P_VALUE));
    const bool done = count >= p.rounds;
    em[0].after(!done, done ? 0 : c.user_int(p.delay_min, p.delay_max, P_DELAY),
                K_TICK, c.node);
    em[1].after(done, 0, KIND_HALT, 0);
  }
};

}  // namespace madsim
