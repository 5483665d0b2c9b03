"""Two-phase commit under chaos, batched over seeds.

Port of ``madsim_tpu/models/twophase.py`` at its default variant
(``record=False``): a coordinator (node 0) drives ``txns`` transactions
over ``n_parts`` participants. PREPARE, then votes (each participant
draws its vote once per transaction and re-sends the stored vote on a
retransmit), then COMMIT when every vote is yes or ABORT on the first
no, then acks. Packet loss and a scheduled participant kill and restart
exercise every retry path: the retransmit loop re-sends whichever
phase's messages are missing, a reborn participant announces itself
with HELLO, and the coordinator arms a loss-free local RESYNC at the
revive time that clears the reborn node's vote or ack bit. The instance
halts when the last transaction is decided and acked by every
participant. The fused kernel carries the same handlers as device code
(``csrc/model_twophase.cuh``).

``record=True`` records one ``OP_DECIDE`` history event (key = txn,
arg = commit) at the coordinator when the votes resolve and one at each
participant that adopts a decision, so ``check.election_safety(h,
elect_op=OP_DECIDE)`` asserts atomicity over the whole run.

Coordinator state: [cur_txn, phase (0 prepare, 1 commit, 2 abort),
                    votes_mask, ack_mask, n_commit, n_abort]
Participant state: [last_prepared, my_vote, last_decided, n_applied,
                    last_decision_value, 0]
"""

from __future__ import annotations

import torch

from ..check.history import OP_USER
from ..engine.core import KIND_KILL, KIND_RESTART, HistorySpec, Workload, set_cols, user_kind

# history op kind (record=True): a decide event per transaction
OP_DECIDE = OP_USER

COORD = 0

_H_INIT = 0
_H_PREPARE = 1  # at participant: args = (txn,)
_H_VOTE = 2  # at coordinator: args = (txn, part, yes)
_H_DECISION = 3  # at participant: args = (txn, commit)
_H_ACK = 4  # at coordinator: args = (txn, part)
_H_RETX = 5  # at coordinator: args = (txn,)
_H_HELLO = 6  # at coordinator: args = (part,), a (re)born participant
_H_HRETX = 7  # at participant: retry HELLO until any traffic seen
_H_RESYNC = 8  # at coordinator: args = (part,), scheduled at revive time

_P_VOTE = 0
_P_KILL_AT = 1
_P_KILL_WHO = 2
_P_REVIVE = 3


def make_twophase(
    txns: int = 5,
    n_parts: int = 4,
    no_pct: int = 10,
    retx_ns: int = 40_000_000,
    chaos: bool = True,
    revive_min_ns: int = 80_000_000,
    revive_max_ns: int = 400_000_000,
    record: bool = False,
) -> Workload:
    """The two-phase-commit workload; ``record=True`` records every
    decision taken or adopted (``OP_DECIDE``)."""
    n = 1 + n_parts
    parts = range(1, n)
    full_mask = (1 << n_parts) - 1

    def _bcast(eb, kind, args, when, skip_mask):
        # rows 0..P-1, one per participant
        for i, p in enumerate(parts):
            eb.send(p, user_kind(kind), args, when=when & (((skip_mask >> i) & 1) == 0))

    def on_init(ctx):
        is_coord = ctx.node == COORD
        is_part = ~is_coord
        eb = ctx.emits()
        _bcast(eb, _H_PREPARE, (1,), is_coord, 0)
        eb.after(retx_ns, user_kind(_H_RETX), COORD, (1,), when=is_coord)
        # announce this (re)born participant; lossy, so retried by a
        # timer until any traffic has been seen
        eb.send(COORD, user_kind(_H_HELLO), (ctx.node,), when=is_part)
        eb.after(retx_ns, user_kind(_H_HRETX), ctx.node, when=is_part)
        if chaos:
            who = ctx.draw.user_int(1, n, _P_KILL_WHO)
            at = ctx.draw.user_int(20_000_000, 250_000_000, _P_KILL_AT)
            revive = ctx.draw.user_int(revive_min_ns, revive_max_ns, _P_REVIVE)
            eb.after(at, KIND_KILL, 0, (who,), when=is_coord)
            eb.after(at + revive, KIND_RESTART, 0, (who,), when=is_coord)
            # loss-free local resync at the revive time
            eb.after(at + revive, user_kind(_H_RESYNC), COORD, (who,), when=is_coord)
        return set_cols(ctx.state, is_coord, {0: 1}), eb.build()

    def on_prepare(ctx):
        txn = ctx.args[:, 0]
        st = ctx.state
        fresh = txn > st[:, 0]
        # the vote is drawn once, at first receipt, and stored
        roll = ctx.draw.user_int(0, 100, _P_VOTE)
        vote = torch.where(fresh, (roll >= no_pct).to(torch.int32), st[:, 1])
        new = st.clone()
        new[:, 0] = torch.maximum(st[:, 0], txn)
        new[:, 1] = vote
        eb = ctx.emits()
        eb.send(COORD, user_kind(_H_VOTE), (txn, ctx.node, vote))
        return new, eb.build()

    def on_vote(ctx):
        txn, who, yes = ctx.args[:, 0], ctx.args[:, 1], ctx.args[:, 2]
        st = ctx.state
        relevant = (txn == st[:, 0]) & (st[:, 1] == 0)
        votes = torch.where(relevant, st[:, 2] | (1 << (who - 1)), st[:, 2])
        abort_now = relevant & (yes == 0)
        commit_now = relevant & (yes != 0) & (votes == full_mask)
        decide = abort_now | commit_now
        phase = torch.where(decide, torch.where(abort_now, 2, 1), st[:, 1])
        new = st.clone()
        new[:, 1] = phase
        new[:, 2] = votes
        new[:, 3] = torch.where(decide, 0, st[:, 3])
        eb = ctx.emits()
        _bcast(eb, _H_DECISION, (txn, (phase == 1).to(torch.int32)), decide, 0)
        if record:
            eb.record(OP_DECIDE, key=txn, arg=(phase == 1).to(torch.int32),
                      when=decide)
        return new, eb.build()

    def on_decision(ctx):
        txn, commit = ctx.args[:, 0], ctx.args[:, 1]
        st = ctx.state
        fresh = txn > st[:, 2]
        new = st.clone()
        new[:, 2] = torch.maximum(st[:, 2], txn)
        new[:, 3] = st[:, 3] + fresh.to(torch.int32)
        # the decision VALUE, so agreement is checkable at halt
        new[:, 4] = torch.where(fresh, commit, st[:, 4])
        eb = ctx.emits()
        eb.send(COORD, user_kind(_H_ACK), (txn, ctx.node))
        if record:
            eb.record(OP_DECIDE, key=txn, arg=commit, when=fresh)
        return new, eb.build()

    def on_ack(ctx):
        txn, who = ctx.args[:, 0], ctx.args[:, 1]
        st = ctx.state
        relevant = (txn == st[:, 0]) & (st[:, 1] >= 1)
        acks = torch.where(relevant, st[:, 3] | (1 << (who - 1)), st[:, 3])
        complete = relevant & (acks == full_mask)
        committed = st[:, 1] == 1
        advance = complete & (st[:, 0] < txns)
        nxt = torch.where(advance, st[:, 0] + 1, st[:, 0])
        new = st.clone()
        new[:, 0] = nxt
        new[:, 1] = torch.where(advance, 0, st[:, 1])
        new[:, 2] = torch.where(advance, 0, st[:, 2])
        new[:, 3] = acks
        new[:, 4] = st[:, 4] + (complete & committed).to(torch.int32)
        new[:, 5] = st[:, 5] + (complete & ~committed).to(torch.int32)
        eb = ctx.emits()
        _bcast(eb, _H_PREPARE, (nxt,), advance, 0)
        eb.after(retx_ns, user_kind(_H_RETX), COORD, (nxt,), when=advance)
        eb.halt(when=complete & (st[:, 0] >= txns))
        return new, eb.build()

    def on_retx(ctx):
        txn = ctx.args[:, 0]
        st = ctx.state
        current = txn == st[:, 0]
        preparing = current & (st[:, 1] == 0)
        deciding = current & (st[:, 1] >= 1)
        eb = ctx.emits()
        # missing votes: re-PREPARE (rows 0..P-1); missing acks:
        # re-DECISION (rows P..2P-1)
        _bcast(eb, _H_PREPARE, (txn,), preparing, st[:, 2])
        _bcast(eb, _H_DECISION, (txn, (st[:, 1] == 1).to(torch.int32)), deciding,
               st[:, 3])
        eb.after(retx_ns, user_kind(_H_RETX), COORD, (txn,), when=current)
        return ctx.state, eb.build()

    def on_clear_bit(ctx):
        # a (re)born participant lost its RAM: clear its bit for the
        # current transaction so the retransmit loop re-covers it
        # (on_hello, lossy, and on_resync, loss-free)
        bit = 1 << (ctx.args[:, 0] - 1)
        st = ctx.state
        preparing = st[:, 1] == 0
        new = st.clone()
        new[:, 2] = torch.where(preparing, st[:, 2] & ~bit, st[:, 2])
        new[:, 3] = torch.where(preparing, st[:, 3], st[:, 3] & ~bit)
        return new, ctx.emits().build()

    def on_hretx(ctx):
        st = ctx.state
        # retry until ANY traffic seen (a prepare or a decision)
        unseen = (st[:, 0] == 0) & (st[:, 2] == 0)
        eb = ctx.emits()
        eb.send(COORD, user_kind(_H_HELLO), (ctx.node,), when=unseen)
        eb.after(retx_ns, user_kind(_H_HRETX), ctx.node, when=unseen)
        return ctx.state, eb.build()

    return Workload(
        name="twophase-record" if record else "twophase",
        n_nodes=n,
        state_width=6,
        handlers=(
            on_init, on_prepare, on_vote, on_decision, on_ack, on_retx,
            on_clear_bit, on_hretx, on_clear_bit,
        ),
        handler_names=(
            "init", "prepare", "vote", "decision", "ack", "retx", "hello",
            "hretx", "resync",
        ),
        # widest: on_retx (2P sends + 1 timer) and on_init (P prepares +
        # retx + hello + hretx + 3 chaos rows)
        max_emits=max(2 * n_parts + 1, n_parts + 6, 6),
        # the largest timer a handler arms (the JAX package's bound)
        delay_bound_ns=max(retx_ns, 250_000_000 + revive_max_ns),
        args_words=3,
        # one coordinator decide and one adoption per participant per
        # txn, and re-adoptions after a restart wipes a participant;
        # overflow is loud (hist_drop)
        history=(
            HistorySpec(capacity=txns * (1 + n_parts) + 16, max_records=1)
            if record else None
        ),
        model_params=(
            ("txns", txns),
            ("n_parts", n_parts),
            ("no_pct", no_pct),
            ("retx_ns", retx_ns),
            ("chaos", chaos),
            ("revive_min_ns", revive_min_ns),
            ("revive_max_ns", revive_max_ns),
        ),
    )
