"""The chaos3 test workload of the torch port's engine tests: three
nodes whose handlers emit every engine kind the ported models leave
dark (kill, restart, pause/resume, link and node clogs, halt) under
loss, as a plain-step workload and as a model trait of the run kernel.
Imports no JAX, so the card-only tests that use it run where JAX is
absent; ``tests/test_torch_engine.py`` holds the plain step against the
JAX engine's copy of these handlers."""

import numpy as np

from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused

N3 = 3
INIT3 = np.array([[0, 5, 9], [0, 6, 9], [0, 7, 9]], np.int32)
CHAOS3_COMMON = dict(
    name="chaos3", n_nodes=N3, state_width=3, max_emits=12,
    init_state=INIT3, args_words=2, durable_cols=(0,), draw_purposes=(0,),
)
CHAOS_CFG = dict(pool_size=24, loss_p=0.1, clog_backoff_min_ns=500_000,
                 clog_backoff_max_ns=8_000_000)


def chaos3_handlers():
    uk = tcore.user_kind

    def add(st, col, v):
        st = st.clone()
        st[:, col] += v
        return st

    def on_init(ctx):
        eb = ctx.emits()
        d = ctx.draw.user_int(1_000_000, 5_000_000, 0)
        eb.after(d, uk(1), ctx.node, (1,))
        eb.send((ctx.node + 1) % N3, uk(2), (ctx.node, 0))
        return add(ctx.state, 2, 1), eb.build()

    def on_tick(ctx):
        st = ctx.state
        r = ctx.draw.user_int(0, 8, 1)
        peer, other = (ctx.node + 1) % N3, (ctx.node + 2) % N3
        eb = ctx.emits()
        eb.kill(peer, when=r == 0)
        eb.restart_after(2_000_000, peer, when=(r == 0) | (r == 1))
        eb.pause(other, when=r == 2)
        eb.resume(other, when=r == 3)
        eb.clog_link(ctx.node, peer, when=r == 4)
        eb.unclog_link(ctx.node, peer, when=(r == 5) | (r == 2))
        eb.after(0, tcore.KIND_CLOG_NODE, 0, (other,), when=r == 6)
        eb.after(0, tcore.KIND_UNCLOG_NODE, 0, (other,), when=r >= 6)
        eb.send(peer, uk(2), (ctx.node, 0), when=r != 7)
        eb.after(3_000_000 + ctx.draw.user_int(0, 2_000_000, 2), uk(1), ctx.node, (1,))
        eb.halt(when=(st[:, 0] >= 6) & (ctx.node == 0))
        return add(st, 0, 1), eb.build()

    def on_ping(ctx):
        st = ctx.state.clone()
        eb = ctx.emits()
        eb.send(ctx.src, uk(2), (ctx.node, ctx.args[:, 1] + 1), when=ctx.args[:, 1] < 3)
        st[:, 1] = ctx.src + 10 * ctx.args[:, 1]
        st[:, 0] += 1
        return st, eb.build()

    return (on_init, on_tick, on_ping)


def chaos3_workload():
    return tcore.Workload(handlers=chaos3_handlers(), **CHAOS3_COMMON)


# the chaos3 workload as a model trait of the run kernel: every engine
# kind raft and the ported models never emit (pause/resume, node clogs,
# the clog reschedule) runs through the kernel's engine code
CHAOS3_MODEL = r"""
#pragma once
#include "engine_step.cuh"
struct Chaos3Model {
  static constexpr int N = 3, U = 3, A = 2, W = 0, K = 12, H = 3;
  static constexpr int R = 0;
  struct Params {};
  static Params params(const int64_t*) { return Params{}; }
  static MADSIM_HD void handle(int32_t h, const madsim::Ctx<Chaos3Model>& c,
                     const Params&, int32_t* ns, madsim::Emit<A, W>* em,
                     madsim::Rec*) {
    using namespace madsim;
    const int32_t tick = FIRST_USER_KIND + 1, ping = FIRST_USER_KIND + 2;
    const int32_t* st = c.state;
    if (h == 0) {
      em[0].after(true, c.user_int(1000000, 5000000, 0), tick, c.node, 1);
      em[1].to(true, (c.node + 1) % N, ping, c.node, 0);
      ns[2] = st[2] + 1;
    } else if (h == 1) {
      const int64_t r = c.user_int(0, 8, 1);
      const int32_t peer = (c.node + 1) % N, other = (c.node + 2) % N;
      em[0].after(r == 0, 0, KIND_KILL, 0, peer);
      em[1].after(r == 0 || r == 1, 2000000, KIND_RESTART, 0, peer);
      em[2].after(r == 2, 0, KIND_PAUSE, 0, other);
      em[3].after(r == 3, 0, KIND_RESUME, 0, other);
      em[4].after(r == 4, 0, KIND_CLOG, 0, c.node, peer);
      em[5].after(r == 5 || r == 2, 0, KIND_UNCLOG, 0, c.node, peer);
      em[6].after(r == 6, 0, KIND_CLOG_NODE, 0, other);
      em[7].after(r >= 6, 0, KIND_UNCLOG_NODE, 0, other);
      em[8].to(r != 7, peer, ping, c.node, 0);
      em[9].after(true, 3000000 + c.user_int(0, 2000000, 2), tick, c.node, 1);
      em[10].after(st[0] >= 6 && c.node == 0, 0, KIND_HALT, 0);
      ns[0] = st[0] + 1;
    } else {
      em[0].to(c.args[1] < 3, c.src, ping, c.node, c.args[1] + 1);
      ns[1] = c.src + 10 * c.args[1];
      ns[0] = st[0] + 1;
    }
  }
};
"""


def chaos3_spec(tmp_dir) -> fused.KernelModel:
    """The chaos3 model trait written to ``tmp_dir`` and described as a
    registry entry, at the shape of :func:`chaos3_workload` and the pool
    of ``CHAOS_CFG``."""
    header = tmp_dir / "model_chaos3.cuh"
    header.write_text(CHAOS3_MODEL)
    return fused.KernelModel(
        "chaos3", "chaos3", str(header), "Chaos3Model",
        fused.workload_shape(chaos3_workload()), (CHAOS_CFG["pool_size"],),
    )


def chaos3_family(tmp_dir) -> tuple:
    """The chaos3 model trait written to ``tmp_dir`` as an entry of
    ``fused.FAMILIES``: its header and the derivation of its one variant
    (the trait's compile-time shape (N, U, A, W, K, H, R), no runtime
    words)."""
    header = tmp_dir / "model_chaos3.cuh"
    header.write_text(CHAOS3_MODEL)

    def derive(wl, p, rec):
        return dict(cxx="Chaos3Model", shape=(3, 3, 2, 0, 12, 3, 0), words=(), fixed=(),
                    tokens=())

    return str(header), derive
