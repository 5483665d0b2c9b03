"""Lai-Yang distributed snapshot over a money-transfer workload.

Port of ``madsim_tpu/models/snapshot.py``: every node starts with
``balance`` units and makes ``n_sends`` random transfers to random
peers on random timers. At a drawn time the initiator (node 0) turns
red and records its balance; every transfer carries its sender's color.
A white node receiving a red transfer records its balance first, then
applies the amount; a red node receiving a white transfer applies it
and counts it as channel state; a node turning red broadcasts a
zero-amount red "paint" transfer to every peer. The family is loss-free
(the engine config has ``loss_p`` 0): the snapshot invariant is
conservation over the cut, ``sum(rec_bal) + sum(chan_in) == n_nodes *
balance``. Every transfer sends a delivery notice to node 0, which
halts the instance when all ``n_nodes * n_sends + n_nodes * (n_nodes -
1)`` messages have landed. The fused kernel carries the same handlers
as device code (``csrc/model_snapshot.cuh``).

State row: [color, bal, rec_bal, chan_in, sent, rcnt]
"""

from __future__ import annotations

import torch

from ..engine.core import Workload, set_cols, user_kind

_H_INIT = 0
_H_SEND = 1  # per-node transfer timer
_H_TRANSFER = 2  # args = (amount, sender_color); paints are amount 0
_H_SNAP = 3  # snapshot start (initiator only)
_H_RECVD = 4  # delivery notice, counted by the witness (node 0)

COLOR, BAL, RECBAL, CHANIN, SENT, RCNT = range(6)

_P_SEND = 0
_P_DST = 1
_P_AMT = 2
_P_SNAP = 3


def make_snapshot(
    n_nodes: int = 5,
    n_sends: int = 6,
    balance: int = 1000,
    amount_max: int = 100,
    send_min_ns: int = 5_000_000,
    send_max_ns: int = 25_000_000,
    snap_min_ns: int = 20_000_000,
    snap_max_ns: int = 80_000_000,
) -> Workload:
    n = n_nodes
    total_msgs = n * n_sends + n * (n - 1)

    def _arm_send(ctx, eb, when):
        d = ctx.draw.user_int(send_min_ns, send_max_ns, _P_SEND)
        eb.after(d, user_kind(_H_SEND), ctx.node, when=when)

    def _paints(ctx, eb, when):
        # zero-amount red transfers to every peer: color propagation;
        # the self slot is present and never valid
        for p in range(n):
            eb.send(p, user_kind(_H_TRANSFER), (0, 1), when=when & (ctx.node != p))

    def on_init(ctx):
        eb = ctx.emits()
        _arm_send(ctx, eb, True)
        snap_d = ctx.draw.user_int(snap_min_ns, snap_max_ns, _P_SNAP)
        eb.after(snap_d, user_kind(_H_SNAP), ctx.node, when=ctx.node == 0)
        new = ctx.state.clone()
        new[:, BAL] = balance
        return new, eb.build()

    def on_send(ctx):
        st = ctx.state
        fire = st[:, SENT] < n_sends
        r = ctx.draw.user_int(0, n - 1, _P_DST)
        dst = (ctx.node + 1 + r) % n  # never self
        amt = ctx.draw.user_int(1, amount_max + 1, _P_AMT).to(torch.int32)
        new = set_cols(st, fire, {BAL: st[:, BAL] - amt, SENT: st[:, SENT] + 1})
        eb = ctx.emits()
        eb.send(dst, user_kind(_H_TRANSFER), (amt, st[:, COLOR]), when=fire)
        _arm_send(ctx, eb, fire & (st[:, SENT] + 1 < n_sends))
        return new, eb.build()

    def on_transfer(ctx):
        st = ctx.state
        amt, mcolor = ctx.args[:, 0], ctx.args[:, 1]
        was_white = st[:, COLOR] == 0
        msg_red = mcolor == 1
        turn = was_white & msg_red
        # Lai-Yang receive rules, in order: record BEFORE applying a
        # first red message; count a white arrival at a red node as
        # channel state; always apply the amount
        st1 = set_cols(st, turn, {COLOR: 1, RECBAL: st[:, BAL]})
        st2 = set_cols(st1, ~was_white & ~msg_red, {CHANIN: st1[:, CHANIN] + amt})
        new = st2.clone()
        new[:, BAL] = st2[:, BAL] + amt
        eb = ctx.emits()
        _paints(ctx, eb, turn)
        eb.send(0, user_kind(_H_RECVD))
        return new, eb.build()

    def on_snap(ctx):
        st = ctx.state
        turn = st[:, COLOR] == 0
        new = set_cols(st, turn, {COLOR: 1, RECBAL: st[:, BAL]})
        eb = ctx.emits()
        _paints(ctx, eb, turn)
        return new, eb.build()

    def on_recvd(ctx):
        cnt = ctx.state[:, RCNT] + 1
        new = ctx.state.clone()
        new[:, RCNT] = cnt
        eb = ctx.emits()
        eb.halt(when=cnt == total_msgs)
        return new, eb.build()

    return Workload(
        name="snapshot",
        n_nodes=n,
        state_width=6,
        handlers=(on_init, on_send, on_transfer, on_snap, on_recvd),
        handler_names=("init", "send", "transfer", "snap", "recvd"),
        # transfer: n paint rows (the self row never valid) + 1 notice
        max_emits=max(n + 1, 2),
        # the largest timer a handler arms (the JAX package's bound)
        delay_bound_ns=max(send_max_ns, snap_max_ns),
        args_words=2,
        model_params=(
            ("n_nodes", n_nodes),
            ("n_sends", n_sends),
            ("balance", balance),
            ("amount_max", amount_max),
            ("send_min_ns", send_min_ns),
            ("send_max_ns", send_max_ns),
            ("snap_min_ns", snap_min_ns),
            ("snap_max_ns", snap_max_ns),
        ),
    )
