"""3-node ping-pong RPC, batched over seeds.

Port of ``madsim_tpu/models/pingpong.py``: one server (node 0) and two
clients (nodes 1, 2). Each client sends ``rounds`` pings, the server
answers each with a pong carrying the same sequence number (the unary
RPC pattern), and the run halts when both clients have finished. The
fused kernel carries the same handlers as device code
(``csrc/model_pingpong.cuh``).

Server state: [completed_clients, pings_served, 0, 0]
Client state: [next_seq, 0, 0, 0]
"""

from __future__ import annotations

from ..engine.core import Workload, user_kind

_H_INIT = 0
_H_PING = 1  # at server: args = (seq, client)
_H_PONG = 2  # at client: args = (seq,)
_H_DONE = 3  # at server: client finished

SERVER = 0


def make_pingpong(rounds: int = 10, n_clients: int = 2) -> Workload:
    n = 1 + n_clients

    def on_init(ctx):
        eb = ctx.emits()
        is_client = ctx.node != SERVER
        eb.send(SERVER, user_kind(_H_PING), (0, ctx.node), when=is_client)
        return ctx.state, eb.build()

    def on_ping(ctx):
        seq, client = ctx.args[:, 0], ctx.args[:, 1]
        new = ctx.state.clone()
        new[:, 1] += 1
        eb = ctx.emits()
        eb.send(client, user_kind(_H_PONG), (seq,))
        return new, eb.build()

    def on_pong(ctx):
        seq = ctx.args[:, 0] + 1
        new = ctx.state.clone()
        new[:, 0] = seq
        done = seq >= rounds
        eb = ctx.emits()
        eb.send(SERVER, user_kind(_H_PING), (seq, ctx.node), when=~done)
        eb.send(SERVER, user_kind(_H_DONE), (), when=done)
        return new, eb.build()

    def on_done(ctx):
        finished = ctx.state[:, 0] + 1
        new = ctx.state.clone()
        new[:, 0] = finished
        eb = ctx.emits()
        eb.halt(when=finished >= n_clients)
        return new, eb.build()

    return Workload(
        name="pingpong",
        n_nodes=n,
        state_width=4,
        handlers=(on_init, on_ping, on_pong, on_done),
        handler_names=("init", "ping", "pong", "done"),
        max_emits=2,
        # the largest timer a handler arms (the JAX package's bound)
        delay_bound_ns=0,
        args_words=2,
        model_params=(("rounds", rounds), ("n_clients", n_clients)),
    )
