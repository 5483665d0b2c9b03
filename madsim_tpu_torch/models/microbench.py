"""Single-node timer + RNG microbenchmark, batched over seeds.

Port of ``madsim_tpu/models/microbench.py``: the pure time/rand core
with no network. A node repeatedly sleeps a random interval and folds a
random draw into an accumulator, ``rounds`` times, then halts. Measures
raw engine event throughput. The fused kernel carries the same handlers
as device code (``csrc/model_microbench.cuh``).

State row: [tick_count, accumulator, 0, 0]
"""

from __future__ import annotations

from ..engine.core import Workload, user_kind

_H_INIT = 0
_H_TICK = 1

# user draw purposes
_P_DELAY = 0
_P_VALUE = 1


def make_microbench(
    rounds: int = 1000,
    delay_min_ns: int = 1_000,
    delay_max_ns: int = 1_000_000,
) -> Workload:
    def on_init(ctx):
        eb = ctx.emits()
        d = ctx.draw.user_int(delay_min_ns, delay_max_ns, _P_DELAY)
        eb.after(d, user_kind(_H_TICK), ctx.node)
        return ctx.state, eb.build()

    def on_tick(ctx):
        st = ctx.state
        count = st[:, 0] + 1
        bits = ctx.draw.user(_P_VALUE).to(st.dtype)
        new = st.clone()
        new[:, 0] = count
        new[:, 1] = st[:, 1] ^ bits
        done = count >= rounds
        eb = ctx.emits()
        d = ctx.draw.user_int(delay_min_ns, delay_max_ns, _P_DELAY)
        eb.after(d, user_kind(_H_TICK), ctx.node, when=~done)
        eb.halt(when=done)
        return new, eb.build()

    return Workload(
        name="microbench",
        n_nodes=1,
        state_width=4,
        handlers=(on_init, on_tick),
        handler_names=("init", "tick"),
        max_emits=2,
        # the largest timer a handler arms (the JAX package's bound)
        delay_bound_ns=delay_max_ns,
        args_words=2,
        draw_purposes=(_P_DELAY, _P_VALUE),
        model_params=(
            ("rounds", rounds),
            ("delay_min_ns", delay_min_ns),
            ("delay_max_ns", delay_max_ns),
        ),
    )
