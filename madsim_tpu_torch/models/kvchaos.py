"""Replicated KV cluster under kill/restart chaos, batched over seeds.

Port of ``madsim_tpu/models/kvchaos.py``: a primary-backup KV store
(one primary, ``n_replicas`` backups, one client) where a write commits
only after a majority of replicas ack. The seed schedules a replica
kill and restart mid-stream; every message kind has a retry path, so
the protocol makes progress through loss and the crash. The run halts
when the client has seen all ``writes`` commits (it sends FIN) and the
primary's ack mask for the final write is full. The fused kernel
carries the same handlers as device code (``csrc/model_kvchaos.cuh``).

``payload=True`` turns on the engine payload arena: each WRITE carries
two random int32 value words drawn by the client; the primary stores
and re-replicates them, replicas store what they receive, and the
payload words feed the trace hash.

Node layout: [primary, replicas 1..R, client R+1]
Primary state:  [committed_seq, inflight_seq, ack_mask, fin_seen(, v0, v1)]
Replica state:  [last_applied_seq, applies, 0, 0] or
                [last_applied_seq, applies, v0, v1, 0, 0] with payload
Client state:   [commits_seen, last_read_rseq, 0, 0(, 0, 0)]

``record=True`` turns on operation histories: the client records every
write as an invoke/response pair (version = seq) and, after each commit,
issues a best-effort READ through the primary and records the committed
version it returns (the ``read``/``readresp`` handlers; a stale-rseq
gate keeps reordered responses out of the history). ``bug=True`` plants
a lost-write fault: a replica's (re)join also makes the primary forget
its commit point. Later acks re-commit everything, so the final state
and the durability invariant look healthy, but a read in the regression
window sees a committed write vanish, which only the history checkers
(``stale_reads``, ``read_your_writes``) see.

``army=True`` opens the client surface for open-loop load: a
``chaos.ClientArmy`` row arriving at the client node (``client_army``
builds the spec) marks the op's invoke and probes the primary, and the
final response marks its completion, so the latency tap measures the
client-observed latency through the authority. ``army_probes=k`` makes
each op a k-round session of chained probes, complete on the k-th
response. The probe path reads protocol state but never writes it.
"""

from __future__ import annotations

import torch

from ..check.history import OK_OK, OK_PENDING, OP_READ, OP_WRITE
from ..engine.core import (
    KIND_KILL,
    KIND_RESTART,
    HistorySpec,
    Workload,
    retry_token_op,
    set_cols,
    user_kind,
)

_H_INIT = 0
_H_WRITE = 1  # at primary: args = (seq,)
_H_REPL = 2  # at replica: args = (seq,)
_H_ACK = 3  # at primary: args = (seq, replica)
_H_COMMIT = 4  # at client: args = (seq,)
_H_RETX = 5  # at primary: args = (seq,)
_H_CRETX = 6  # at client: periodic progress retry
_H_FIN = 7  # at primary: client done
_H_JOIN = 8  # at primary: args = (replica,), a replica (re)joined
_H_JRETX = 9  # at replica: retry JOIN until synced
_H_READ = 10  # at primary: args = (rseq,), record mode only
_H_READRESP = 11  # at client: args = (rseq, committed), record mode only
_H_AREQ = 12  # at client: army op arrival, args = (op_id, word), army mode
_H_APROBE = 13  # at primary: army probe, args = (op_id, rounds left)
_H_ARESP = 14  # at client: army response, args = (op_id, rounds left)

PRIMARY = 0

_P_KILL_AT = 0
_P_KILL_WHO = 1
_P_REVIVE = 2
_P_VAL0 = 8
_P_VAL1 = 9


def make_kvchaos(
    writes: int = 20,
    n_replicas: int = 4,
    retx_ns: int = 40_000_000,
    client_retx_ns: int = 100_000_000,
    chaos: bool = True,
    payload: bool = False,
    record: bool = False,
    hist_capacity: int | None = None,
    bug: bool = False,
    army: bool = False,
    army_probes: int = 1,
) -> Workload:
    """The replicated-KV workload; ``record=True`` records the client's
    write and read history (4 records a write unless ``hist_capacity``
    says otherwise), ``bug=True`` plants the lost-write fault and
    ``army=True`` adds the client-army handlers (``army_probes`` rounds
    an op)."""
    if bug and not record:
        raise ValueError(
            "bug=True plants a fault only histories can see; it requires "
            "record=True (otherwise nothing would ever detect it)"
        )
    n = 1 + n_replicas + 1
    client = n - 1
    replicas = list(range(1, 1 + n_replicas))
    majority = n_replicas // 2 + 1
    full_mask = (1 << n_replicas) - 1
    width = 6 if payload else 4

    def _client_value(ctx):
        """Two fresh random words for an outgoing WRITE (payload mode)."""
        if not payload:
            return ()
        v0 = ctx.draw.user(_P_VAL0).to(torch.int32)
        v1 = ctx.draw.user(_P_VAL1).to(torch.int32)
        return (v0, v1)

    def _replicate(eb, seq, when, mask, pay=()):
        for i, r in enumerate(replicas):
            eb.send(
                r, user_kind(_H_REPL), (seq,),
                when=when & (((mask >> i) & 1) == 0),
                pay=pay,
            )

    def on_init(ctx):
        eb = ctx.emits()
        is_client = ctx.node == client
        is_replica = (ctx.node >= 1) & (ctx.node <= n_replicas)
        # client kicks off write 1 and its progress-retry timer
        eb.send(PRIMARY, user_kind(_H_WRITE), (1,), when=is_client,
                pay=_client_value(ctx))
        if record:  # write 1 is invoked here (retries are the same op)
            eb.record(OP_WRITE, 0, 1, ok=OK_PENDING, when=is_client)
        eb.after(client_retx_ns, user_kind(_H_CRETX), client, when=is_client)
        # replicas announce themselves, at t=0 and again after restart;
        # retried by a timer until the first write applies
        eb.send(PRIMARY, user_kind(_H_JOIN), (ctx.node,), when=is_replica)
        eb.after(retx_ns, user_kind(_H_JRETX), ctx.node, when=is_replica)
        if chaos:
            who = ctx.draw.user_int(1, 1 + n_replicas, _P_KILL_WHO)
            at = ctx.draw.user_int(20_000_000, 300_000_000, _P_KILL_AT)
            revive = ctx.draw.user_int(100_000_000, 600_000_000, _P_REVIVE)
            eb.after(at, KIND_KILL, 0, (who,), when=is_client)
            eb.after(at + revive, KIND_RESTART, 0, (who,), when=is_client)
        return ctx.state, eb.build()

    def on_write(ctx):
        seq = ctx.args[:, 0]
        st = ctx.state
        fresh = (seq > st[:, 0]) & (seq > st[:, 1])
        cols = {1: seq, 2: 0}
        if payload:
            # the first WRITE to arrive for a seq fixes its value; the
            # primary stores it so retx re-sends the accepted value
            cols.update({4: ctx.payload[:, 0], 5: ctx.payload[:, 1]})
        new = set_cols(st, fresh, cols)
        eb = ctx.emits()
        pay = (new[:, 4], new[:, 5]) if payload else ()
        _replicate(eb, seq, fresh, 0, pay)
        eb.after(retx_ns, user_kind(_H_RETX), PRIMARY, (seq,), when=fresh)
        return new, eb.build()

    def on_repl(ctx):
        seq = ctx.args[:, 0]
        st = ctx.state
        fresh = seq > st[:, 0]
        new = st.clone()
        new[:, 0] = torch.maximum(st[:, 0], seq)
        new[:, 1] = st[:, 1] + 1
        if payload:
            new = set_cols(new, fresh, {2: ctx.payload[:, 0], 3: ctx.payload[:, 1]})
        eb = ctx.emits()
        eb.send(PRIMARY, user_kind(_H_ACK), (seq, ctx.node))
        return new, eb.build()

    def _maybe_halt(eb, committed, mask, fin):
        eb.halt(when=(committed >= writes) & (mask == full_mask) & (fin > 0))

    def on_ack(ctx):
        seq, who = ctx.args[:, 0], ctx.args[:, 1]
        st = ctx.state
        bit = 1 << (who - 1)
        current = seq == st[:, 1]
        mask = torch.where(current, st[:, 2] | bit, st[:, 2])
        acks = torch.zeros_like(mask)
        for i in range(n_replicas):
            acks = acks + ((mask >> i) & 1)
        committed_now = current & (seq > st[:, 0]) & (acks >= majority)
        committed = torch.where(committed_now, seq, st[:, 0])
        new = st.clone()
        new[:, 0] = committed
        new[:, 2] = mask
        eb = ctx.emits()
        eb.send(client, user_kind(_H_COMMIT), (committed,),
                when=current & (committed >= seq))
        _maybe_halt(eb, committed, mask, st[:, 3])
        return new, eb.build()

    def on_commit(ctx):
        seq = ctx.args[:, 0]
        st = ctx.state
        fresh = seq > st[:, 0]
        new = set_cols(st, fresh, {0: seq})
        done = seq >= writes
        eb = ctx.emits()
        eb.send(PRIMARY, user_kind(_H_WRITE), (seq + 1,), when=fresh & ~done,
                pay=_client_value(ctx))
        eb.send(PRIMARY, user_kind(_H_FIN), (), when=fresh & done)
        if record:
            # close the pending write with its committed version, then
            # probe it with a READ through the primary (rseq = seq). The
            # write's response precedes the read's invoke, so the read's
            # version floor includes it
            eb.record(OP_WRITE, 0, seq, ok=OK_OK, when=fresh)
            eb.record(OP_READ, 0, 0, ok=OK_PENDING, when=fresh)
            eb.send(PRIMARY, user_kind(_H_READ), (seq,), when=fresh)
            eb.record(OP_WRITE, 0, seq + 1, ok=OK_PENDING, when=fresh & ~done)
        return new, eb.build()

    def on_retx(ctx):
        seq = ctx.args[:, 0]
        st = ctx.state
        current = seq == st[:, 1]
        pending_repl = current & (st[:, 2] != full_mask)
        # committed but the client may not know (lost COMMIT): re-ack
        pending_commit = current & (st[:, 0] >= seq)
        eb = ctx.emits()
        _replicate(eb, seq, pending_repl, st[:, 2],
                   (st[:, 4], st[:, 5]) if payload else ())
        eb.send(client, user_kind(_H_COMMIT), (st[:, 0],), when=pending_commit)
        eb.after(retx_ns, user_kind(_H_RETX), PRIMARY, (seq,),
                 when=pending_repl | pending_commit)
        return ctx.state, eb.build()

    def on_cretx(ctx):
        # client progress guard: re-send the write (or FIN) it is waiting on
        st = ctx.state
        waiting = st[:, 0] < writes
        eb = ctx.emits()
        eb.send(PRIMARY, user_kind(_H_WRITE), (st[:, 0] + 1,), when=waiting,
                pay=_client_value(ctx))
        eb.send(PRIMARY, user_kind(_H_FIN), (), when=~waiting)
        eb.after(client_retx_ns, user_kind(_H_CRETX), client)
        return ctx.state, eb.build()

    def on_fin(ctx):
        st = ctx.state
        new = st.clone()
        new[:, 3] = 1
        eb = ctx.emits()
        _maybe_halt(eb, st[:, 0], st[:, 2], 1)
        return new, eb.build()

    def on_join(ctx):
        # a replica (re)joined with empty state: clear its ack bit so the
        # retx loop re-replicates the current write to it
        who = ctx.args[:, 0]
        st = ctx.state
        bit = 1 << (who - 1)
        new = st.clone()
        new[:, 2] = st[:, 2] & ~bit
        if bug:
            # the planted lost-write fault: re-admitting a replica also
            # forgets the commit point
            new[:, 0] = 0
        eb = ctx.emits()
        # the retx timer may have died while the mask was full: re-arm
        eb.after(retx_ns, user_kind(_H_RETX), PRIMARY, (st[:, 1],),
                 when=st[:, 1] > 0)
        return new, eb.build()

    def on_jretx(ctx):
        st = ctx.state
        behind = st[:, 0] == 0
        eb = ctx.emits()
        eb.send(PRIMARY, user_kind(_H_JOIN), (ctx.node,), when=behind)
        eb.after(retx_ns, user_kind(_H_JRETX), ctx.node, when=behind)
        return ctx.state, eb.build()

    def on_read(ctx):
        # answer a client history probe with the current commit point
        rseq = ctx.args[:, 0]
        eb = ctx.emits()
        eb.send(client, user_kind(_H_READRESP), (rseq, ctx.state[:, 0]))
        return ctx.state, eb.build()

    def on_readresp(ctx):
        # stale-rseq gate: only in-invoke-order responses enter the
        # history; a gated-out read stays pending, which constrains nothing
        rseq, committed = ctx.args[:, 0], ctx.args[:, 1]
        st = ctx.state
        fresh_r = rseq > st[:, 1]
        eb = ctx.emits()
        if record:
            eb.record(OP_READ, 0, committed, ok=OK_OK, when=fresh_r)
        return set_cols(st, fresh_r, {1: rseq}), eb.build()

    if army_probes < 1:
        raise ValueError(f"army_probes must be >= 1, got {army_probes}")

    def on_areq(ctx):
        # an army op arrives at the client: mark its invoke and open the
        # session; args[1] of the probe is the rounds owed after it. The
        # token's op id is stripped (the identity without retries)
        op_id = retry_token_op(ctx.args[:, 0])
        eb = ctx.emits()
        eb.lat_start(op_id)
        eb.send(PRIMARY, user_kind(_H_APROBE), (op_id, army_probes - 1))
        return ctx.state, eb.build()

    def on_aprobe(ctx):
        # the authority echoes the rounds left: a read-only probe
        eb = ctx.emits()
        eb.send(client, user_kind(_H_ARESP), (ctx.args[:, 0], ctx.args[:, 1]))
        return ctx.state, eb.build()

    def on_aresp(ctx):
        op_id, left = ctx.args[:, 0], ctx.args[:, 1]
        eb = ctx.emits()
        # chain the next round; 0 left completes the op
        eb.send(PRIMARY, user_kind(_H_APROBE), (op_id, left - 1), when=left > 0)
        eb.lat_end(op_id, when=left == 0)
        return ctx.state, eb.build()

    # per write one invoke, one response, one read invoke and at most
    # one read response: 4 records
    hist = None
    if record:
        # every write adds one write op and at most one read op on key
        # 0, a single register whose exact check is bounded at 63 ops
        if 2 * writes > 63:
            raise ValueError(
                f"record=True supports at most 31 writes: {writes} "
                f"writes record up to {2 * writes} ops on the single "
                f"key, past the 63-op bound of the exact checker "
                f"(check/linearize.py); lower writes or record "
                f"without the exact sweep"
            )
        cap = 4 * writes if hist_capacity is None else hist_capacity
        hist = HistorySpec(capacity=cap, max_records=3)
    name = "kvchaos-payload" if payload else "kvchaos"
    if record:
        name += "-bug" if bug else "-record"
    handlers = (
        on_init, on_write, on_repl, on_ack, on_commit, on_retx,
        on_cretx, on_fin, on_join, on_jretx, on_read, on_readresp,
    )
    if army:
        name += "-army"
        handlers += (on_areq, on_aprobe, on_aresp)

    return Workload(
        name=name,
        n_nodes=n,
        state_width=width,
        handlers=handlers,
        handler_names=(
            "init", "write", "repl", "ack", "commit", "retx", "cretx",
            "fin", "join", "jretx", "read", "readresp",
        ) + (("areq", "aprobe", "aresp") if army else ()),
        # on_init builds up to 6 rows; on_retx builds n_replicas+2
        max_emits=max(n_replicas + 2, 6),
        # the largest timer a handler arms (the JAX package's bound)
        delay_bound_ns=max(retx_ns, client_retx_ns, 900_000_000),
        args_words=2,
        payload_words=2 if payload else 0,
        draw_purposes=((_P_KILL_AT, _P_KILL_WHO, _P_REVIVE) if chaos else ())
        + ((_P_VAL0, _P_VAL1) if payload else ()),
        history=hist,
        # army mode: one lat_start or lat_end a call
        lat_markers=1 if army else 0,
        model_params=(
            ("writes", writes),
            ("n_replicas", n_replicas),
            ("retx_ns", retx_ns),
            ("client_retx_ns", client_retx_ns),
            ("chaos", chaos),
            ("payload", payload),
            ("record", record),
            ("bug", bug),
            ("army", army),
            ("army_probes", army_probes),
        ),
    )


def client_army(
    n_ops: int = 256,
    t_min_ns: int = 20_000_000,
    t_max_ns: int = 400_000_000,
    n_replicas: int = 4,
    op_base: int = 0,
    retry=None,
):
    """A :class:`chaos.ClientArmy` bound to kvchaos's client surface
    (``make_kvchaos(army=True)`` with the same ``n_replicas``): ops
    arrive at the client node and probe the primary. Compose it into a
    ``FaultPlan`` beside the chaos specs and run with
    ``latency=LatencySpec(ops >= op_base + n_ops)``. ``retry`` (a
    ``chaos.RetryPolicy``) makes the engine re-send ops that see no
    response in time (``plan.retry_spec()``)."""
    from ..chaos.plan import ClientArmy

    return ClientArmy(
        node=1 + n_replicas,  # [primary, replicas 1..R, client R+1]
        kind=user_kind(_H_AREQ),
        n_ops=n_ops,
        t_min_ns=t_min_ns,
        t_max_ns=t_max_ns,
        op_base=op_base,
        retry=retry,
    )


def lint_entries():
    """The non-interference matrix's entry points (``lint.model_matrix``):
    ``(tag, workload, engine-config kwargs)``, the JAX package's rows."""
    kw = dict(pool_size=40, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
    return [
        ("kvchaos/plain", make_kvchaos(), kw),
        ("kvchaos/record", make_kvchaos(record=True, payload=True), kw),
        ("kvchaos/army", make_kvchaos(army=True), kw),
    ]


# The certification horizon of the column contracts: client-army load windows span sim-seconds;
# 300 sim-seconds leaves an order of magnitude of slack (the JAX
# package's value).
ABSINT_HORIZON_NS = 300 * 1_000_000_000


def absint_entries():
    """The range checks' entry points: :func:`lint_entries` rows with the
    horizon, ``(tag, workload, engine-config kwargs, horizon ns)``."""
    return [(tag, wl, kw, ABSINT_HORIZON_NS) for tag, wl, kw in lint_entries()]
