"""Raft log replication under leader-crash chaos, batched over seeds.

Port of ``madsim_tpu/models/raftlog.py`` at its default variant
(``chaos=True``, diskless, no army, no coverage words), with or without
recording:
an elected leader proposes ``n_writes`` entries one at a time,
replicates each with AppendEntries carrying its whole log prefix in the
event payload, commits it on a majority of acks, and every seed
schedules one node kill and a later restart. The instance halts when
the final entry commits. The vote check is raft's lexicographic
up-to-date rule, and a new leader re-stamps its uncommitted suffix with
its own term (the figure-8 guard). Log entries pack as
``value | term << 8`` in one int32 state word. The fused kernel carries
the same handlers as device code (``csrc/model_raftlog.cuh``).

``record=True`` records every election win (``OP_ELECT``, key = term,
arg = winner) and, at each leader commit, one ``OP_COMMIT`` event per
newly committed index (key = index, arg = the entry's value byte), so
``check.election_safety`` asserts one winner per term and log agreement
over the whole run. The value byte, not the whole entry: the win-time
re-stamp rewrites the term byte of the uncommitted suffix, so after a
leader restart the same value is legitimately re-committed under a
higher term.

State row: [role, term, voted_term, votes, timer_seq, log_len,
            commit, ack_mask, log_0 .. log_{W-1}]
"""

from __future__ import annotations

import torch

from ..check.history import OP_USER
from ..engine.core import KIND_KILL, KIND_RESTART, HistorySpec, Workload, set_cols, user_kind

# history op kinds (record=True): an election win and a leader commit
OP_ELECT = OP_USER
OP_COMMIT = OP_USER + 1

_H_INIT = 0
_H_TIMEOUT = 1  # args = (timer_seq,)
_H_REQVOTE = 2  # args = (term, candidate, cand_loglen, cand_lastterm)
_H_GRANT = 3  # args = (term,)
_H_APPEND = 4  # args = (term, idx, leader_commit, leader); pay = full log
_H_ACKAPP = 5  # args = (term, idx, follower)
_H_PROPOSE = 6  # leader propose timer; args = (term,)
_H_RETX = 7  # leader retransmit timer; args = (term,)

ROLE, TERM, VOTED, VOTES, TSEQ, LOGLEN, COMMIT, ACKS = range(8)
LOG0 = 8
FOLLOWER, CANDIDATE, LEADER = 0, 1, 2

_P_TIMEOUT = 0
_P_VALUE = 1
_P_KILL_AT = 2
_P_KILL_WHO = 3
_P_REVIVE = 4


def make_raftlog(
    n_nodes: int = 5,
    n_writes: int = 4,
    timeout_min_ns: int = 150_000_000,
    timeout_max_ns: int = 300_000_000,
    propose_ns: int = 20_000_000,
    retx_ns: int = 60_000_000,
    chaos: bool = True,
    durable: bool = False,
    record: bool = False,
    bug: str | None = None,
    army: bool = False,
    cov_spread: bool = False,
) -> Workload:
    """The log-replication workload; ``record=True`` records elections
    and commits. ``durable``, ``bug``, ``army`` and ``cov_spread`` raise
    ``NotImplementedError`` until the sync discipline, latency markers
    and coverage words are ported (ROADMAP queue A8)."""
    if durable or bug is not None or army or cov_spread:
        raise NotImplementedError(
            "make_raftlog is ported diskless, with or without record; "
            "durable, bug, army and cov_spread need the sync discipline, "
            "the latency markers and coverage words, which the torch "
            "port does not have yet (ROADMAP queue A8)"
        )
    majority = n_nodes // 2 + 1
    nodes = list(range(n_nodes))
    w = n_writes
    width = LOG0 + w

    def _log(st):
        return st[:, LOG0 : LOG0 + w]

    def _jv(st):
        return torch.arange(w, dtype=torch.int32, device=st.device)[None, :]

    def _lastterm(st):
        """Term of the last log entry (0 for an empty log)."""
        hit = _jv(st) + 1 == st[:, LOGLEN : LOGLEN + 1]
        return torch.where(hit, _log(st) >> 8, 0).sum(1).to(torch.int32)

    def _arm_election(ctx, eb, new_seq, when):
        d = ctx.draw.user_int(timeout_min_ns, timeout_max_ns, _P_TIMEOUT)
        eb.after(d, user_kind(_H_TIMEOUT), ctx.node, (new_seq,), when=when)

    def _send_appends(ctx, eb, st, term, when):
        """Replicate the sender's full log (install-style) to every peer."""
        idx = st[:, LOGLEN] - 1
        pay = tuple(st[:, LOG0 + j] for j in range(w))
        for p in nodes:
            eb.send(
                p, user_kind(_H_APPEND), (term, idx, st[:, COMMIT], ctx.node),
                when=when & (ctx.node != p), pay=pay,
            )

    def on_init(ctx):
        eb = ctx.emits()
        _arm_election(ctx, eb, 1, True)
        if chaos:
            # node 0's t=0 init schedules the seed's chaos plan (restarted
            # nodes re-run on_init, but later re-inits see now > 0)
            first = (ctx.node == 0) & (ctx.now == 0)
            who = ctx.draw.user_int(0, n_nodes, _P_KILL_WHO)
            at = ctx.draw.user_int(200_000_000, 500_000_000, _P_KILL_AT)
            revive = ctx.draw.user_int(100_000_000, 600_000_000, _P_REVIVE)
            eb.after(at, KIND_KILL, 0, (who,), when=first)
            eb.after(at + revive, KIND_RESTART, 0, (who,), when=first)
        new = ctx.state.clone()
        new[:, TSEQ] = 1
        return new, eb.build()

    def on_timeout(ctx):
        st = ctx.state
        fire = (ctx.args[:, 0] == st[:, TSEQ]) & (st[:, ROLE] != LEADER)
        term = st[:, TERM] + 1
        new = set_cols(st, fire, {ROLE: CANDIDATE, TERM: term, VOTED: term,
                              VOTES: 1, TSEQ: st[:, TSEQ] + 1})
        eb = ctx.emits()
        lt = _lastterm(st)
        for p in nodes:
            eb.send(
                p, user_kind(_H_REQVOTE), (term, ctx.node, st[:, LOGLEN], lt),
                when=fire & (ctx.node != p),
            )
        _arm_election(ctx, eb, st[:, TSEQ] + 1, fire)
        # the reference's re-arm of a timeout withheld by a failing disk:
        # a row that is never valid without the sync discipline
        _arm_election(ctx, eb, st[:, TSEQ], False)
        return new, eb.build()

    def on_reqvote(ctx):
        st = ctx.state
        term, cand = ctx.args[:, 0], ctx.args[:, 1]
        c_len, c_lt = ctx.args[:, 2], ctx.args[:, 3]
        newer = term > st[:, TERM]
        st1 = set_cols(st, newer, {TERM: term, ROLE: FOLLOWER, VOTES: 0})
        # the up-to-date rule: candidate's (last term, length) >= ours
        my_lt = _lastterm(st1)
        up_to_date = (c_lt > my_lt) | ((c_lt == my_lt) & (c_len >= st1[:, LOGLEN]))
        grant = (term == st1[:, TERM]) & (st1[:, VOTED] < term) & up_to_date
        new = set_cols(st1, grant, {VOTED: term, TSEQ: st1[:, TSEQ] + 1})
        eb = ctx.emits()
        eb.send(cand, user_kind(_H_GRANT), (term,), when=grant)
        _arm_election(ctx, eb, st1[:, TSEQ] + 1, grant)
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
        # win-time re-stamp: the uncommitted suffix takes the new term
        log = _log(new)
        stamped = (log & 0xFF) | (term[:, None] << 8)
        jv = _jv(new)
        restamp = (
            wins[:, None] & (jv >= new[:, COMMIT : COMMIT + 1])
            & (jv < new[:, LOGLEN : LOGLEN + 1])
        )
        new[:, LOG0 : LOG0 + w] = torch.where(restamp, stamped, log)
        has_inflight = new[:, LOGLEN] > new[:, COMMIT]
        acks = torch.where(has_inflight, 1 << ctx.node, 0)
        new[:, ACKS] = torch.where(wins, acks, new[:, ACKS])
        eb = ctx.emits()
        _send_appends(ctx, eb, new, term, wins)
        eb.after(propose_ns, user_kind(_H_PROPOSE), ctx.node, (term,), when=wins)
        eb.after(retx_ns, user_kind(_H_RETX), ctx.node, (term,), when=wins)
        if record:
            eb.record(OP_ELECT, key=term, arg=ctx.node, when=wins)
        return new, eb.build()

    def on_append(ctx):
        st = ctx.state
        term, idx, l_commit = ctx.args[:, 0], ctx.args[:, 1], ctx.args[:, 2]
        leader = ctx.args[:, 3]
        ok = term >= st[:, TERM]
        newer_term = term > st[:, TERM]
        new = set_cols(st, ok, {TERM: term, ROLE: FOLLOWER, TSEQ: st[:, TSEQ] + 1})
        # adopt the leader's full log prefix (single-inflight install);
        # a same-term append may only extend
        adopt = ok & (idx >= 0) & (newer_term | (idx + 1 >= st[:, LOGLEN]))
        take = adopt[:, None] & (_jv(st) <= idx[:, None])
        new[:, LOG0 : LOG0 + w] = torch.where(take, ctx.payload[:, :w], _log(new))
        new[:, LOGLEN] = torch.where(adopt, idx + 1, new[:, LOGLEN])
        new[:, COMMIT] = torch.where(
            ok, torch.maximum(new[:, COMMIT], l_commit), new[:, COMMIT]
        )
        eb = ctx.emits()
        eb.send(leader, user_kind(_H_ACKAPP), (term, idx, ctx.node), when=adopt)
        # a heartbeat resets the election timer
        _arm_election(ctx, eb, st[:, TSEQ] + 1, ok)
        return new, eb.build()

    def on_ackapp(ctx):
        st = ctx.state
        term, idx, frm = ctx.args[:, 0], ctx.args[:, 1], ctx.args[:, 2]
        counts = (
            (st[:, ROLE] == LEADER) & (term == st[:, TERM])
            & (idx == st[:, LOGLEN] - 1) & (st[:, COMMIT] < st[:, LOGLEN])
        )
        acks = torch.where(counts, st[:, ACKS] | (1 << frm), st[:, ACKS])
        n_acks = torch.zeros_like(acks)
        for p in range(n_nodes):
            n_acks = n_acks + ((acks >> p) & 1)
        commit_now = counts & (n_acks >= majority)
        new = st.clone()
        new[:, ACKS] = acks
        new[:, COMMIT] = torch.where(commit_now, idx + 1, st[:, COMMIT])
        eb = ctx.emits()
        # propagate the commit index immediately
        _send_appends(ctx, eb, new, term, commit_now)
        if record:
            # one event per newly committed index (a caught-up leader
            # may commit several at once), with the entry's value byte
            for j in range(w):
                eb.record(
                    OP_COMMIT, key=j, arg=new[:, LOG0 + j] & 0xFF,
                    when=commit_now & (j >= st[:, COMMIT]) & (j <= idx),
                )
        eb.halt(when=commit_now & (new[:, COMMIT] == w))
        return new, eb.build()

    def on_propose(ctx):
        st = ctx.state
        term = ctx.args[:, 0]
        alive_leader = (st[:, ROLE] == LEADER) & (term == st[:, TERM])
        can = alive_leader & (st[:, COMMIT] == st[:, LOGLEN]) & (st[:, LOGLEN] < w)
        value = (ctx.draw.user(_P_VALUE) & 0xFF).to(torch.int32)
        entry = value | (st[:, TERM] << 8)
        ins = can[:, None] & (_jv(st) == st[:, LOGLEN : LOGLEN + 1])
        new = st.clone()
        new[:, LOG0 : LOG0 + w] = torch.where(ins, entry[:, None], _log(st))
        new = set_cols(new, can, {LOGLEN: st[:, LOGLEN] + 1, ACKS: 1 << ctx.node})
        eb = ctx.emits()
        _send_appends(ctx, eb, new, term, can)
        eb.after(propose_ns, user_kind(_H_PROPOSE), ctx.node, (term,),
                 when=alive_leader)
        return new, eb.build()

    def on_retx(ctx):
        st = ctx.state
        term = ctx.args[:, 0]
        alive_leader = (st[:, ROLE] == LEADER) & (term == st[:, TERM])
        # re-replicate whatever is outstanding; doubles as the heartbeat
        send = alive_leader & (st[:, LOGLEN] > 0)
        eb = ctx.emits()
        _send_appends(ctx, eb, st, term, send)
        eb.after(retx_ns, user_kind(_H_RETX), ctx.node, (term,), when=alive_leader)
        return ctx.state, eb.build()

    return Workload(
        name="raftlog-record" if record else "raftlog",
        n_nodes=n_nodes,
        state_width=width,
        handlers=(
            on_init, on_timeout, on_reqvote, on_grant, on_append,
            on_ackapp, on_propose, on_retx,
        ),
        # widest: on_timeout and on_grant, N rows plus two timers
        max_emits=n_nodes + 2,
        payload_words=w,
        args_words=4,
        # a handful of elections a run, and w commit records plus the
        # re-commits after leader changes; overflow is loud (hist_drop)
        history=(
            HistorySpec(capacity=6 * w + 24, max_records=max(w, 1))
            if record else None
        ),
        draw_purposes=(_P_TIMEOUT, _P_VALUE)
        + ((_P_KILL_AT, _P_KILL_WHO, _P_REVIVE) if chaos else ()),
        model_params=(
            ("n_nodes", n_nodes),
            ("n_writes", n_writes),
            ("timeout_min_ns", timeout_min_ns),
            ("timeout_max_ns", timeout_max_ns),
            ("propose_ns", propose_ns),
            ("retx_ns", retx_ns),
            ("chaos", chaos),
        ),
    )
