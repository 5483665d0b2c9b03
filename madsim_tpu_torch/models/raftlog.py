"""Raft log replication under leader-crash chaos, batched over seeds.

Port of ``madsim_tpu/models/raftlog.py``, with or without recording,
diskless or durable, with or without the client army:
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

``durable=True`` keeps the raft paper's Figure-2 persistent columns
(TERM, VOTED, LOGLEN and the log) across a kill under the two-phase
sync discipline (``Workload.durable_sync``): every handler that dirties
them syncs in the same dispatch, before its messages go out, so with no
injected disk fault the trajectory is that of verbatim-durable columns
(the C++ oracle's). Inside an observable fsync-EIO window
(``ctx.sync_err``) a node withholds candidacy, vote grants, append acks
and proposals, and retries after it. ``bug="nosync"`` plants the
missing-sync mutant: no handler syncs, so a kill wipes every
"persistent" write back to the initial row. With ``record=True`` a
durable node also records ``OP_SYNCED`` (a synced log-length change)
and ``OP_RECOVER`` (the length a restarted node came back with), which
``check.recovery_safety`` judges.

``army=True`` appends one client node (index ``n_nodes``) that runs no
raft: a ``chaos.ClientArmy`` op (``client_army``) arriving there marks
its invoke and probes server ``op_id % n_nodes``, which answers with its
commit index (a read-only dirty read), and the response marks the op's
completion for the latency tap.

State row: [role, term, voted_term, votes, timer_seq, log_len,
            commit, ack_mask, log_0 .. log_{W-1}]
"""

from __future__ import annotations

import torch

from ..check.history import OP_USER
from ..engine.core import KIND_KILL, KIND_RESTART, HistorySpec, Workload, set_cols, user_kind
from ..engine.rng import M32

# history op kinds (record=True): an election win and a leader commit;
# with durable=True also a synced log-length change and a recovery
OP_ELECT = OP_USER
OP_COMMIT = OP_USER + 1
OP_SYNCED = OP_USER + 2
OP_RECOVER = OP_USER + 3

_H_INIT = 0
_H_TIMEOUT = 1  # args = (timer_seq,)
_H_REQVOTE = 2  # args = (term, candidate, cand_loglen, cand_lastterm)
_H_GRANT = 3  # args = (term,)
_H_APPEND = 4  # args = (term, idx, leader_commit, leader); pay = full log
_H_ACKAPP = 5  # args = (term, idx, follower)
_H_PROPOSE = 6  # leader propose timer; args = (term,)
_H_RETX = 7  # leader retransmit timer; args = (term,)
_H_AREQ = 8  # at client: army op arrival, args = (op_id, word), army mode
_H_APROBE = 9  # at server: army probe, args = (op_id,)
_H_ARESP = 10  # at client: army response, args = (op_id, commit)

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
    and commits, ``durable=True`` persists the Figure-2 columns under the
    sync discipline and ``bug="nosync"`` never syncs them.
    ``cov_spread=True`` adds the fleet's commit-index spread to the
    coverage features (``Workload.cov_features``). ``army=True`` appends
    the client node of the client army."""
    if bug not in (None, "nosync"):
        raise ValueError(f"unknown raftlog bug {bug!r} (only 'nosync')")
    if bug and not durable:
        raise ValueError(
            "bug='nosync' plants a missing-sync mutant: it needs "
            "durable=True (diskless mode has no syncs to miss)"
        )
    majority = n_nodes // 2 + 1
    nodes = list(range(n_nodes))
    # the army's client node comes after the servers: the raft loops run
    # over `nodes`, so no protocol traffic or chaos draw touches it
    n_total = n_nodes + (1 if army else 0)
    client = n_nodes
    w = n_writes
    width = LOG0 + w
    # the correct placement syncs every durable write in the dispatch
    # that made it; the planted mutant never syncs
    sync_en = durable and bug != "nosync"
    rec_store = record and durable

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

    def _eio(ctx):
        """The node's observable fsync-EIO flag; constant False for the
        diskless and nosync variants."""
        if sync_en and ctx.sync_err is not None:
            return ctx.sync_err
        return torch.zeros_like(ctx.node, dtype=torch.bool)

    def on_init(ctx):
        eb = ctx.emits()
        # the army's client runs no raft: no election timer, no records
        is_server = ctx.node < n_nodes if army else True
        _arm_election(ctx, eb, 1, is_server)
        if rec_store:
            # a re-init at now > 0 is a restarted node reading its disk
            # back: the log length it recovered with
            eb.record(OP_RECOVER, key=0, arg=ctx.state[:, LOGLEN],
                      when=(ctx.now > 0) & is_server)
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
        due = (ctx.args[:, 0] == st[:, TSEQ]) & (st[:, ROLE] != LEADER)
        err = _eio(ctx)
        # a node whose disk is failing cannot persist its candidacy: it
        # re-arms the same timer seq and retries after the window
        fire = due & ~err
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
        _arm_election(ctx, eb, st[:, TSEQ], due & err)
        if sync_en:
            # currentTerm and votedFor: fsync before the requests leave
            eb.sync(when=fire)
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
        # a vote that cannot be persisted (an EIO window) is withheld
        grant = (term == st1[:, TERM]) & (st1[:, VOTED] < term) & up_to_date & ~_eio(ctx)
        new = set_cols(st1, grant, {VOTED: term, TSEQ: st1[:, TSEQ] + 1})
        eb = ctx.emits()
        eb.send(cand, user_kind(_H_GRANT), (term,), when=grant)
        _arm_election(ctx, eb, st1[:, TSEQ] + 1, grant)
        if sync_en:
            # a granted vote, or a bare term bump, hits the disk first
            eb.sync(when=newer | grant)
        return new, eb.build()

    def on_grant(ctx):
        st = ctx.state
        term = ctx.args[:, 0]
        counts = (st[:, ROLE] == CANDIDATE) & (term == st[:, TERM])
        votes = torch.where(counts, st[:, VOTES] + 1, st[:, VOTES])
        # a candidate whose disk is failing defers leadership: the
        # re-stamp must be persisted before re-replication
        wins = counts & (votes >= majority) & ~_eio(ctx)
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
        if sync_en:
            # the re-stamp rewrote log terms: persist before replicating
            eb.sync(when=wins)
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
        # inside an EIO window the adopted entries cannot be synced: the
        # ack waits for the leader's retransmission after it
        err = _eio(ctx)
        eb.send(leader, user_kind(_H_ACKAPP), (term, idx, ctx.node), when=adopt & ~err)
        # a heartbeat resets the election timer
        _arm_election(ctx, eb, st[:, TSEQ] + 1, ok)
        if sync_en:
            # adopted entries and the term bump fsync before the ack
            eb.sync(when=ok)
        if rec_store and sync_en:
            # a committed log-length change
            eb.record(OP_SYNCED, key=0, arg=idx + 1,
                      when=adopt & ~err & (idx + 1 != st[:, LOGLEN]))
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
        # a leader with a failing disk does not propose (its own ack is
        # a durability promise); the propose timer retries
        can = (alive_leader & (st[:, COMMIT] == st[:, LOGLEN]) & (st[:, LOGLEN] < w)
               & ~_eio(ctx))
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
        if sync_en:
            # the leader's own append fsyncs before it counts its ack
            eb.sync(when=can)
        if rec_store and sync_en:
            eb.record(OP_SYNCED, key=0, arg=st[:, LOGLEN] + 1, when=can)
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

    def on_areq(ctx):
        # an army op arrives at the client: mark its invoke and probe one
        # server, round-robin by op id; an open-loop client never retries
        op_id = ctx.args[:, 0]
        eb = ctx.emits()
        eb.lat_start(op_id)
        eb.send(op_id % n_nodes, user_kind(_H_APROBE), (op_id,))
        return ctx.state, eb.build()

    def on_aprobe(ctx):
        # a dirty read: any live server answers with its commit index
        eb = ctx.emits()
        eb.send(client, user_kind(_H_ARESP), (ctx.args[:, 0], ctx.state[:, COMMIT]))
        return ctx.state, eb.build()

    def on_aresp(ctx):
        eb = ctx.emits()
        eb.lat_end(ctx.args[:, 0])
        return ctx.state, eb.build()

    handlers = (
        on_init, on_timeout, on_reqvote, on_grant, on_append,
        on_ackapp, on_propose, on_retx,
    )
    if army:
        handlers += (on_areq, on_aprobe, on_aresp)

    def _commit_spread(ns, now):
        """Protocol coverage (Workload.cov_features, ``cov_spread``): the
        servers' commit-index spread, and the (floor, spread) pair, each
        field masked to its byte."""
        c = ns[:, :n_nodes, COMMIT].to(torch.int64)
        lo = c.min(1).values & M32
        spread = ((c.max(1).values & M32) - lo) & M32
        return (
            (spread, True),
            ((lo & 0xFF) | ((spread & 0xFF) << 8) | (1 << 16), True),
        )

    return Workload(
        name="raftlog" + ("-nosync" if bug == "nosync" else "")
        + ("-record" if record else "") + ("-army" if army else ""),
        n_nodes=n_total,
        state_width=width,
        handlers=handlers,
        handler_names=(
            "init", "timeout", "reqvote", "grant", "append", "ackapp",
            "propose", "retx",
        ) + (("areq", "aprobe", "aresp") if army else ()),
        # widest: on_timeout and on_grant, N rows plus two timers
        max_emits=n_nodes + 2,
        payload_words=w,
        # the largest timer a handler arms (the JAX package's bound)
        delay_bound_ns=max(timeout_max_ns, propose_ns, retx_ns, 1_100_000_000),
        args_words=4,
        # the Figure-2 columns, under the sync discipline
        durable_cols=(
            (TERM, VOTED, LOGLEN) + tuple(LOG0 + j for j in range(w)) if durable else None
        ),
        durable_sync=durable,
        # a handful of elections a run, and w commit records plus the
        # re-commits after leader changes; durable mode adds the length
        # events and recoveries; overflow is loud (hist_drop)
        history=(
            HistorySpec(capacity=6 * w + 24 + (n_nodes * (w + 6) if durable else 0),
                        max_records=max(w, 1))
            if record else None
        ),
        draw_purposes=(_P_TIMEOUT, _P_VALUE)
        + ((_P_KILL_AT, _P_KILL_WHO, _P_REVIVE) if chaos else ()),
        cov_features=_commit_spread if cov_spread else None,
        # army mode: one lat_start or lat_end a call
        lat_markers=1 if army else 0,
        model_params=(
            ("n_nodes", n_nodes),
            ("n_writes", n_writes),
            ("timeout_min_ns", timeout_min_ns),
            ("timeout_max_ns", timeout_max_ns),
            ("propose_ns", propose_ns),
            ("retx_ns", retx_ns),
            ("chaos", chaos),
            ("durable", durable),
            ("bug", bug),
            ("cov_spread", cov_spread),
            ("army", army),
        ),
    )


def client_army(
    n_ops: int = 256,
    t_min_ns: int = 20_000_000,
    t_max_ns: int = 400_000_000,
    n_nodes: int = 5,
    op_base: int = 0,
):
    """A :class:`chaos.ClientArmy` bound to raftlog's client surface
    (``make_raftlog(army=True)`` with the same ``n_nodes``): ops arrive
    at the appended client node and probe server ``op_id % n_nodes``.
    Run with ``latency=LatencySpec(ops >= op_base + n_ops)``."""
    from ..chaos.plan import ClientArmy

    return ClientArmy(
        node=n_nodes,  # the appended client node
        kind=user_kind(_H_AREQ),
        n_ops=n_ops,
        t_min_ns=t_min_ns,
        t_max_ns=t_max_ns,
        op_base=op_base,
    )


def lint_entries():
    """The non-interference matrix's entry points (``lint.model_matrix``):
    ``(tag, workload, engine-config kwargs)``, the JAX package's rows."""
    kw = dict(pool_size=64, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
    return [
        ("raftlog/plain", make_raftlog(), kw),
        ("raftlog/record", make_raftlog(record=True), kw),
        ("raftlog/durable", make_raftlog(durable=True, record=True), kw),
        ("raftlog/army", make_raftlog(army=True), kw),
    ]


# The certification horizon of the column contracts: chaos soaks replicate for sim-minutes;
# 300 sim-seconds leaves an order of magnitude of slack (the JAX
# package's value).
ABSINT_HORIZON_NS = 300 * 1_000_000_000


def absint_entries():
    """The range checks' entry points: :func:`lint_entries` rows with the
    horizon, ``(tag, workload, engine-config kwargs, horizon ns)``."""
    return [(tag, wl, kw, ABSINT_HORIZON_NS) for tag, wl, kw in lint_entries()]
