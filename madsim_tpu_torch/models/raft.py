"""Raft-style 5-node leader election, batched over seeds.

Port of ``madsim_tpu/models/raft.py``: five nodes with randomized
election timeouts (150-300 ms) race to win a majority under 1-10 ms
message latency and packet loss. The seed decides every timeout and
latency draw; the instance halts when a leader first wins an election
(halt_time = election latency).

State row: [role, term, voted_term, votes, timeout_seq, 0]
  role: 0 follower, 1 candidate, 2 leader

Handlers take and return whole batches: an ``(S, U)`` state row and
``(S, A)`` args in, the new ``(S, U)`` rows and ``(S, K)`` emits out.
The fused kernel carries the same handlers as device code
(``csrc/model_raft.cuh``).

``record=True`` records every election win as an instantaneous
``OP_ELECT`` history event (key = term, arg = winner):
``check.election_safety(h, elect_op=OP_ELECT)`` is the history analog
of the one-leader-per-term invariant.
"""

from __future__ import annotations

import torch

from ..check.history import OP_USER
from ..engine.core import HistorySpec, Workload, user_kind

# history op kind (record=True): an election win
OP_ELECT = OP_USER

_H_INIT = 0
_H_TIMEOUT = 1  # args = (timeout_seq,)
_H_REQVOTE = 2  # args = (term, candidate)
_H_GRANT = 3  # args = (term,)
_H_HEARTBEAT = 4  # args = (term,)

ROLE, TERM, VOTED, VOTES, TSEQ = 0, 1, 2, 3, 4
FOLLOWER, CANDIDATE, LEADER = 0, 1, 2

_P_TIMEOUT = 0


def make_raft(
    n_nodes: int = 5,
    timeout_min_ns: int = 150_000_000,
    timeout_max_ns: int = 300_000_000,
    record: bool = False,
) -> Workload:
    """The election workload; ``record=True`` records each election
    win (``OP_ELECT``, key = term, arg = the winner)."""
    majority = n_nodes // 2 + 1
    nodes = list(range(n_nodes))

    def _arm_timer(ctx, eb, new_seq, when):
        d = ctx.draw.user_int(timeout_min_ns, timeout_max_ns, _P_TIMEOUT)
        eb.after(d, user_kind(_H_TIMEOUT), ctx.node, (new_seq,), when=when)

    def on_init(ctx):
        eb = ctx.emits()
        _arm_timer(ctx, eb, 1, True)
        new = ctx.state.clone()
        new[:, TSEQ] = 1
        return new, eb.build()

    def on_timeout(ctx):
        st = ctx.state
        fire = (ctx.args[:, 0] == st[:, TSEQ]) & (st[:, ROLE] != LEADER)
        term = st[:, TERM] + 1
        cand = st.clone()
        cand[:, ROLE] = CANDIDATE
        cand[:, TERM] = term
        cand[:, VOTED] = term
        cand[:, VOTES] = 1
        cand[:, TSEQ] = st[:, TSEQ] + 1
        new = torch.where(fire[:, None], cand, st)
        eb = ctx.emits()
        for p in nodes:
            eb.send(
                p, user_kind(_H_REQVOTE), (term, ctx.node),
                when=fire & (ctx.node != p),
            )
        _arm_timer(ctx, eb, st[:, TSEQ] + 1, fire)
        return new, eb.build()

    def on_reqvote(ctx):
        st = ctx.state
        term, cand = ctx.args[:, 0], ctx.args[:, 1]
        # step down on a newer term
        newer = term > st[:, TERM]
        down = st.clone()
        down[:, TERM] = term
        down[:, ROLE] = FOLLOWER
        down[:, VOTES] = 0
        st1 = torch.where(newer[:, None], down, st)
        grant = (term == st1[:, TERM]) & (st1[:, VOTED] < term)
        voted = st1.clone()
        voted[:, VOTED] = term
        voted[:, TSEQ] = st1[:, TSEQ] + 1
        new = torch.where(grant[:, None], voted, st1)
        eb = ctx.emits()
        eb.send(cand, user_kind(_H_GRANT), (term,), when=grant)
        # granting resets the election timer (vote then wait)
        _arm_timer(ctx, eb, st1[:, TSEQ] + 1, grant)
        return new, eb.build()

    def on_grant(ctx):
        st = ctx.state
        term = ctx.args[:, 0]
        counts = (st[:, ROLE] == CANDIDATE) & (term == st[:, TERM])
        votes = torch.where(counts, st[:, VOTES] + 1, st[:, VOTES])
        wins = counts & (votes >= majority)
        new = st.clone()
        new[:, VOTES] = votes
        new[:, ROLE] = torch.where(wins, LEADER, new[:, ROLE])
        eb = ctx.emits()
        for p in nodes:
            eb.send(
                p, user_kind(_H_HEARTBEAT), (term,),
                when=wins & (ctx.node != p),
            )
        # leader elected: scenario complete (halt_time = election latency)
        eb.halt(when=wins)
        if record:
            eb.record(OP_ELECT, key=term, arg=ctx.node, when=wins)
        return new, eb.build()

    def on_heartbeat(ctx):
        st = ctx.state
        term = ctx.args[:, 0]
        accept = term >= st[:, TERM]
        fol = st.clone()
        fol[:, TERM] = term
        fol[:, ROLE] = FOLLOWER
        fol[:, TSEQ] = st[:, TSEQ] + 1
        new = torch.where(accept[:, None], fol, st)
        eb = ctx.emits()
        _arm_timer(ctx, eb, st[:, TSEQ] + 1, accept)
        return new, eb.build()

    return Workload(
        name="raft-election-record" if record else "raft-election",
        n_nodes=n_nodes,
        state_width=6,
        handlers=(on_init, on_timeout, on_reqvote, on_grant, on_heartbeat),
        handler_names=("init", "timeout", "reqvote", "grant", "heartbeat"),
        max_emits=n_nodes + 1,
        # the largest timer a handler arms (the JAX package's bound)
        delay_bound_ns=timeout_max_ns,
        args_words=2,
        draw_purposes=(_P_TIMEOUT,),
        # the run halts at the first win, so concurrent in-flight wins
        # bound the recorded events at a handful; 8 slots is generous
        history=HistorySpec(capacity=8, max_records=1) if record else None,
        model_params=(
            ("n_nodes", n_nodes),
            ("timeout_min_ns", timeout_min_ns),
            ("timeout_max_ns", timeout_max_ns),
        ),
    )


def lint_entries():
    """The non-interference matrix's entry points (``lint.model_matrix``):
    ``(tag, workload, engine-config kwargs)``, the JAX package's rows."""
    kw = dict(pool_size=40, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
    return [
        ("raft/plain", make_raft(), kw),
        ("raft/record", make_raft(record=True), kw),
    ]


# The certification horizon of the column contracts: elections resolve within sim-seconds;
# 60 sim-seconds leaves an order of magnitude of slack (the JAX
# package's value).
ABSINT_HORIZON_NS = 60 * 1_000_000_000


def absint_entries():
    """The range checks' entry points: :func:`lint_entries` rows with the
    horizon, ``(tag, workload, engine-config kwargs, horizon ns)``."""
    return [(tag, wl, kw, ABSINT_HORIZON_NS) for tag, wl, kw in lint_entries()]
