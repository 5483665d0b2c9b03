"""Single-decree Paxos with dueling proposers and proposer-crash chaos.

Port of ``madsim_tpu/models/paxos.py`` at its default variant
(``record=False``): ``n_acceptors`` acceptors (nodes ``0..A-1``) and
``n_proposers`` proposers (nodes ``A..A+P-1``) run classic synod
consensus. Each proposer wants its own value (``pidx + 1``) chosen,
ballots are globally unique (``round * P + pidx + 1``), random
per-round timeouts break the dueling-proposers livelock, and a NACK
naming a higher ballot fast-forwards the round counter. Chaos kills one
random proposer and restarts it later; a reborn proposer re-runs
on_init with wiped state. A proposer that reaches a choosing majority
sends DECIDED to every other proposer and to acceptor 0, whose receipt
halts the instance. The fused kernel carries the same handlers as
device code (``csrc/model_paxos.cuh``).

``durable_acceptors=True`` (acceptor columns 0-2 survive a restart, and
the kill aims at an acceptor) runs on the CPU; the kernel carries the
default variant and ``record=True``. ``record=True`` records an
``OP_DECIDE`` history event (key 0, arg = the value) when a proposer
first reaches a choosing majority and when a proposer first adopts a
decision it hears: ``check.election_safety(h, elect_op=OP_DECIDE)`` is
then agreement over every decision observed along the run.

Acceptor state row: [promised, accepted_bal, accepted_val, 0, ...]
Proposer state row: [phase (0 idle 1 prepare 2 accept 3 done), ballot,
                     value, promise_count, best_bal, best_val,
                     accept_count, decided, round, timer_seq]
"""

from __future__ import annotations

import torch

from ..check.history import OP_USER
from ..engine.core import KIND_KILL, KIND_RESTART, HistorySpec, Workload, set_cols, user_kind

# history op kind (record=True): a decide event
OP_DECIDE = OP_USER

_H_INIT = 0
_H_PROPOSE = 1  # at proposer (timer): args = (tseq,)
_H_PREPARE = 2  # at acceptor: args = (ballot,)
_H_PROMISE = 3  # at proposer: args = (ballot, acc_bal, acc_val)
_H_ACCEPT = 4  # at acceptor: args = (ballot, value)
_H_ACCEPTED = 5  # at proposer: args = (ballot,)
_H_DECIDED = 6  # anywhere: args = (value,)
_H_NACK = 7  # at proposer: args = (promised,)

A_PROM, A_BAL, A_VAL = 0, 1, 2
P_PHASE, P_BAL, P_VAL, P_PCNT, P_BESTB, P_BESTV, P_ACNT, P_DEC, P_ROUND, P_TSEQ = (
    range(10)
)
IDLE, PREPARING, ACCEPTING, DONE = 0, 1, 2, 3

_P_START = 0
_P_TIMEOUT = 1
_P_KILL_AT = 2
_P_KILL_WHO = 3
_P_REVIVE = 4


def make_paxos(
    n_acceptors: int = 5,
    n_proposers: int = 3,
    start_min_ns: int = 5_000_000,
    start_max_ns: int = 30_000_000,
    timeout_min_ns: int = 60_000_000,
    timeout_max_ns: int = 120_000_000,
    chaos: bool = True,
    kill_min_ns: int = 30_000_000,
    kill_max_ns: int = 150_000_000,
    revive_min_ns: int = 80_000_000,
    revive_max_ns: int = 300_000_000,
    durable_acceptors: bool = False,
    record: bool = False,
) -> Workload:
    """The Paxos workload; ``record=True`` records every decision a
    proposer reaches or first adopts (``OP_DECIDE``)."""
    a, p = n_acceptors, n_proposers
    if durable_acceptors and a < 2:
        raise ValueError(
            "durable_acceptors needs n_acceptors >= 2: the kill target is "
            "drawn from acceptors 1..A-1 (acceptor 0 is the halt witness)"
        )
    n = a + p
    majority = a // 2 + 1

    def _arm(ctx, eb, tseq, when, lo, hi, purpose):
        d = ctx.draw.user_int(lo, hi, purpose)
        eb.after(d, user_kind(_H_PROPOSE), ctx.node, (tseq,), when=when)

    def on_init(ctx):
        is_prop = ctx.node >= a
        eb = ctx.emits()
        _arm(ctx, eb, 1, is_prop, start_min_ns, start_max_ns, _P_START)
        if chaos:
            # acceptor 0's t=0 init schedules the seed's chaos plan
            first = (ctx.node == 0) & (ctx.now == 0)
            if durable_acceptors:
                who = 1 + ctx.draw.user_int(0, a - 1, _P_KILL_WHO)
            else:
                who = a + ctx.draw.user_int(0, p, _P_KILL_WHO)
            at = ctx.draw.user_int(kill_min_ns, kill_max_ns, _P_KILL_AT)
            revive = ctx.draw.user_int(revive_min_ns, revive_max_ns, _P_REVIVE)
            eb.after(at, KIND_KILL, 0, (who,), when=first)
            eb.after(at + revive, KIND_RESTART, 0, (who,), when=first)
        return set_cols(ctx.state, is_prop, {P_TSEQ: 1}), eb.build()

    def on_propose(ctx):
        st = ctx.state
        live = (ctx.args[:, 0] == st[:, P_TSEQ]) & (ctx.node >= a)
        fire = live & (st[:, P_DEC] == 0)
        # a decided proposer keeps the timer chain alive to re-deliver
        # DECIDED to the halt witness (acceptor 0)
        redeliver = live & (st[:, P_DEC] != 0)
        ballot = st[:, P_ROUND] * p + (ctx.node - a) + 1
        new = set_cols(st, redeliver, {P_TSEQ: st[:, P_TSEQ] + 1})
        new = set_cols(new, fire, {
            P_PHASE: PREPARING, P_BAL: ballot, P_PCNT: 0, P_BESTB: 0,
            P_BESTV: 0, P_ACNT: 0, P_ROUND: st[:, P_ROUND] + 1,
            P_TSEQ: st[:, P_TSEQ] + 1,
        })
        eb = ctx.emits()
        eb.send(0, user_kind(_H_DECIDED), (st[:, P_DEC],), when=redeliver)
        for acc in range(a):
            eb.send(acc, user_kind(_H_PREPARE), (ballot,), when=fire)
        # the retry chain: a fresh timer per attempt, tseq-guarded
        _arm(ctx, eb, st[:, P_TSEQ] + 1, fire | redeliver, timeout_min_ns,
             timeout_max_ns, _P_TIMEOUT)
        return new, eb.build()

    def on_prepare(ctx):
        st = ctx.state
        b = ctx.args[:, 0]
        grant = b > st[:, A_PROM]
        eb = ctx.emits()
        eb.send(ctx.src, user_kind(_H_PROMISE), (b, st[:, A_BAL], st[:, A_VAL]),
                when=grant)
        eb.send(ctx.src, user_kind(_H_NACK), (st[:, A_PROM],), when=~grant)
        return set_cols(st, grant, {A_PROM: b}), eb.build()

    def on_promise(ctx):
        st = ctx.state
        b, abal, aval = ctx.args[:, 0], ctx.args[:, 1], ctx.args[:, 2]
        relevant = (st[:, P_PHASE] == PREPARING) & (b == st[:, P_BAL])
        pcnt = torch.where(relevant, st[:, P_PCNT] + 1, st[:, P_PCNT])
        better = relevant & (abal > st[:, P_BESTB])
        bestb = torch.where(better, abal, st[:, P_BESTB])
        bestv = torch.where(better, aval, st[:, P_BESTV])
        won = relevant & (pcnt >= majority)
        # adopt the highest-ballot accepted value heard, else our own
        value = torch.where(bestb > 0, bestv, ctx.node - a + 1)
        new = st.clone()
        new[:, P_PCNT] = pcnt
        new[:, P_BESTB] = bestb
        new[:, P_BESTV] = bestv
        new = set_cols(new, won, {P_PHASE: ACCEPTING, P_VAL: value, P_ACNT: 0})
        eb = ctx.emits()
        for acc in range(a):
            eb.send(acc, user_kind(_H_ACCEPT), (b, value), when=won)
        return new, eb.build()

    def on_accept(ctx):
        st = ctx.state
        b, v = ctx.args[:, 0], ctx.args[:, 1]
        ok = b >= st[:, A_PROM]
        eb = ctx.emits()
        eb.send(ctx.src, user_kind(_H_ACCEPTED), (b,), when=ok)
        eb.send(ctx.src, user_kind(_H_NACK), (st[:, A_PROM],), when=~ok)
        return set_cols(st, ok, {A_PROM: b, A_BAL: b, A_VAL: v}), eb.build()

    def on_accepted(ctx):
        st = ctx.state
        b = ctx.args[:, 0]
        relevant = (st[:, P_PHASE] == ACCEPTING) & (b == st[:, P_BAL])
        acnt = torch.where(relevant, st[:, P_ACNT] + 1, st[:, P_ACNT])
        chosen = relevant & (acnt >= majority)
        new = st.clone()
        new[:, P_ACNT] = acnt
        new = set_cols(new, chosen, {P_PHASE: DONE, P_DEC: st[:, P_VAL]})
        eb = ctx.emits()
        for prop in range(a, n):
            eb.send(prop, user_kind(_H_DECIDED), (st[:, P_VAL],),
                    when=chosen & (ctx.node != prop))
        # acceptor 0 is the halt witness
        eb.send(0, user_kind(_H_DECIDED), (st[:, P_VAL],), when=chosen)
        if record:
            eb.record(OP_DECIDE, key=0, arg=st[:, P_VAL], when=chosen)
        return new, eb.build()

    def on_decided(ctx):
        st = ctx.state
        v = ctx.args[:, 0]
        dec = torch.where(st[:, P_DEC] == 0, v, st[:, P_DEC])
        new = set_cols(st, ctx.node >= a, {P_DEC: dec, P_PHASE: DONE})
        eb = ctx.emits()
        eb.halt(when=ctx.node == 0)
        if record:
            # first adoption only (P_DEC was 0): what this proposer now
            # believes was decided
            eb.record(OP_DECIDE, key=0, arg=v,
                      when=(ctx.node >= a) & (st[:, P_DEC] == 0))
        return new, eb.build()

    def on_nack(ctx):
        st = ctx.state
        b = ctx.args[:, 0]
        # a NACK naming a higher ballot kills this round: abandon it and
        # fast-forward so the next ballot exceeds what we saw
        act = (ctx.node >= a) & (b > st[:, P_BAL]) & (st[:, P_DEC] == 0)
        ffwd = torch.div(b, p, rounding_mode="floor") + 1
        new = set_cols(st, act, {
            P_PHASE: IDLE, P_ROUND: torch.maximum(st[:, P_ROUND], ffwd),
        })
        return new, ctx.emits().build()

    return Workload(
        name="paxos-record" if record else "paxos",
        n_nodes=n,
        state_width=10,
        handlers=(
            on_init, on_propose, on_prepare, on_promise, on_accept,
            on_accepted, on_decided, on_nack,
        ),
        handler_names=(
            "init", "propose", "prepare", "promise", "accept", "accepted",
            "decided", "nack",
        ),
        # widest: on_propose (1 DECIDED redelivery + A prepares + 1
        # timer); on_accepted sends P DECIDEDs; on_init 1 timer + 2 chaos
        max_emits=max(a + 2, p + 1, 3),
        # the largest timer a handler arms (the JAX package's bound)
        delay_bound_ns=max(timeout_max_ns, kill_max_ns + revive_max_ns),
        args_words=3,
        durable_cols=(A_PROM, A_BAL, A_VAL) if durable_acceptors else None,
        # decide records: at most one per chosen round and one first
        # adoption per proposer incarnation; overflow is loud (hist_drop)
        history=HistorySpec(capacity=32, max_records=1) if record else None,
        draw_purposes=(_P_START, _P_TIMEOUT)
        + ((_P_KILL_AT, _P_KILL_WHO, _P_REVIVE) if chaos else ()),
        model_params=(
            ("n_acceptors", n_acceptors),
            ("n_proposers", n_proposers),
            ("start_min_ns", start_min_ns),
            ("start_max_ns", start_max_ns),
            ("timeout_min_ns", timeout_min_ns),
            ("timeout_max_ns", timeout_max_ns),
            ("chaos", chaos),
            ("kill_min_ns", kill_min_ns),
            ("kill_max_ns", kill_max_ns),
            ("revive_min_ns", revive_min_ns),
            ("revive_max_ns", revive_max_ns),
            ("durable_acceptors", durable_acceptors),
        ),
    )


def lint_entries():
    """The non-interference matrix's entry points (``lint.model_matrix``):
    ``(tag, workload, engine-config kwargs)``, the JAX package's rows."""
    kw = dict(pool_size=48, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
    return [
        ("paxos/plain", make_paxos(), kw),
        ("paxos/record", make_paxos(record=True), kw),
    ]


# The certification horizon of the column contracts: a ballot settles within sim-seconds;
# 60 sim-seconds leaves an order of magnitude of slack (the JAX
# package's value).
ABSINT_HORIZON_NS = 60 * 1_000_000_000


def absint_entries():
    """The range checks' entry points: :func:`lint_entries` rows with the
    horizon, ``(tag, workload, engine-config kwargs, horizon ns)``."""
    return [(tag, wl, kw, ABSINT_HORIZON_NS) for tag, wl, kw in lint_entries()]
