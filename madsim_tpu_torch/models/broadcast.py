"""5-node reliable broadcast under chaos, batched over seeds.

Port of ``madsim_tpu/models/broadcast.py``: node 0 broadcasts
``rounds`` sequenced messages to 4 peers, collecting acks and
retransmitting on timeout, so the protocol makes progress through
packet loss and the random link partition the origin schedules at init
(engine CLOG/UNCLOG events). The run halts when every round is fully
acked. The fused kernel carries the same handlers as device code
(``csrc/model_broadcast.cuh``).

Origin state:   [current_seq, ack_mask, 0, 0]
Receiver state: [last_seen_seq, acks_sent, 0, 0]
"""

from __future__ import annotations

import torch

from ..engine.core import KIND_CLOG, KIND_UNCLOG, Workload, set_cols, user_kind

_H_INIT = 0
_H_MSG = 1  # at receiver: args = (seq,)
_H_ACK = 2  # at origin:   args = (seq, peer)
_H_RETX = 3  # at origin:   args = (seq,)

ORIGIN = 0

# user draw purposes
_P_RETX = 0
_P_CHAOS_LINK = 1
_P_CHAOS_AT = 2
_P_CHAOS_LEN = 3


def make_broadcast(
    rounds: int = 5,
    n_nodes: int = 5,
    retx_ns: int = 50_000_000,
    partition: bool = True,
) -> Workload:
    peers = list(range(1, n_nodes))
    full_mask = (1 << len(peers)) - 1

    def _bcast(eb, seq, when):
        for p in peers:
            eb.send(p, user_kind(_H_MSG), (seq,), when=when)

    def on_init(ctx):
        is_origin = ctx.node == ORIGIN
        eb = ctx.emits()
        _bcast(eb, 1, is_origin)
        eb.after(retx_ns, user_kind(_H_RETX), ORIGIN, (1,), when=is_origin)
        if partition:
            # partition a random non-origin link for a random window:
            # chaos the retransmit path must survive
            a = ctx.draw.user_int(1, n_nodes, _P_CHAOS_LINK)
            b_raw = ctx.draw.user_int(1, n_nodes - 1, _P_CHAOS_LINK + 16)
            b = torch.where(b_raw >= a, b_raw + 1, b_raw)
            at = ctx.draw.user_int(0, 100_000_000, _P_CHAOS_AT)
            length = ctx.draw.user_int(50_000_000, 400_000_000, _P_CHAOS_LEN)
            eb.after(at, KIND_CLOG, 0, (a, b), when=is_origin)
            eb.after(at + length, KIND_UNCLOG, 0, (a, b), when=is_origin)
        return set_cols(ctx.state, is_origin, {0: 1}), eb.build()

    def on_msg(ctx):
        seq = ctx.args[:, 0]
        st = ctx.state
        new = st.clone()
        new[:, 0] = torch.maximum(st[:, 0], seq)
        new[:, 1] = st[:, 1] + 1
        eb = ctx.emits()
        # always ack (idempotent) so lost acks are re-covered by retx
        eb.send(ORIGIN, user_kind(_H_ACK), (seq, ctx.node))
        return new, eb.build()

    def on_ack(ctx):
        seq, peer = ctx.args[:, 0], ctx.args[:, 1]
        cur, mask = ctx.state[:, 0], ctx.state[:, 1]
        bit = 1 << (peer - 1)
        mask = torch.where(seq == cur, mask | bit, mask)
        complete = mask == full_mask
        last_round = cur >= rounds
        advance = complete & ~last_round
        nxt = torch.where(advance, cur + 1, cur)
        new_mask = torch.where(advance, 0, mask)
        eb = ctx.emits()
        _bcast(eb, nxt, advance)
        eb.after(retx_ns, user_kind(_H_RETX), ORIGIN, (nxt,), when=advance)
        eb.halt(when=complete & last_round)
        new = ctx.state.clone()
        new[:, 0] = nxt
        new[:, 1] = new_mask
        return new, eb.build()

    def on_retx(ctx):
        seq = ctx.args[:, 0]
        cur, mask = ctx.state[:, 0], ctx.state[:, 1]
        pending = (seq == cur) & (mask != full_mask)
        eb = ctx.emits()
        for i, p in enumerate(peers):
            unacked = ((mask >> i) & 1) == 0
            eb.send(p, user_kind(_H_MSG), (cur,), when=pending & unacked)
        eb.after(retx_ns, user_kind(_H_RETX), ORIGIN, (cur,), when=pending)
        return ctx.state, eb.build()

    return Workload(
        name="broadcast",
        n_nodes=n_nodes,
        state_width=4,
        handlers=(on_init, on_msg, on_ack, on_retx),
        handler_names=("init", "msg", "ack", "retx"),
        max_emits=max(len(peers) + 3, 6),
        # the largest timer a handler arms (the JAX package's bound)
        delay_bound_ns=max(retx_ns, 500_000_000),
        args_words=2,
        draw_purposes=(
            (_P_CHAOS_LINK, _P_CHAOS_LINK + 16, _P_CHAOS_AT, _P_CHAOS_LEN)
            if partition
            else ()
        ),
        model_params=(
            ("rounds", rounds),
            ("n_nodes", n_nodes),
            ("retx_ns", retx_ns),
            ("partition", partition),
        ),
    )
