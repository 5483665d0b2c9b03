"""Sharded KV with key-range migration under chaos, batched over seeds.

Port of ``madsim_tpu/models/shardkv.py``: a configuration epoch maps
``n_shards`` key ranges onto ``n_groups`` replica groups (a primary and
backups each); a controller rebalances by migrating one shard at a
time: freeze the shard at its source primary, hand its version to the
destination primary, and commit the new epoch only after the
destination confirms the install; the source keeps its frozen copy
until the controller's RELEASE. A stop-and-wait client writes
round-robin over the shards, refetching the configuration when a
primary redirects it. Chaos kills a random primary mid-run and restarts
it. Every column is durable (disk-backed servers: a restart keeps the
whole row), and the initial state is not zero: it holds the initial
assignment and ownership epochs. The instance halts when the client's
writes are done and ``n_migs`` migrations have committed. The fused
kernel carries the same handlers as device code
(``csrc/model_shardkv.cuh``).

``record=True`` records every committed write (``OP_SHARD_WRITE``, key =
shard, arg = version) and every ownership install (``OP_SHARD_OWN``,
key = shard, arg = ``pack_shard_own(epoch, group, version)``), so
``check.shard_coverage`` can hold both safety clauses: one owner per
(shard, epoch), and no committed write lost across a migration.
``bug=True`` plants the lost-shard mutant: the source releases the
shard the moment it sends the handoff, so a retried handoff re-sends
version 0 and the destination installs it, dropping committed writes.
``army=True`` opens the client node as an open-loop surface
(``client_army``): each op applies an exactly-once put (a dedup floor in
client column 3, recorded as ``OP_ARMY_PUT`` with ``record=True``), marks
its invoke and probes the controller for ``army_probes`` rounds before
marking its completion. ``bug="noidem"`` plants the non-idempotent
retried put: the apply skips the floor, so an op that a client retry
delivers twice applies twice, which only ``check.exactly_once`` sees.

Node layout: [controller 0, client 1, then group g's replicas at
2+g*R .. 2+g*R+R-1 (primary first)]
Primary/backup state: [ver(shard 0..S-1), epoch(shard 0..S-1), frozen]
Controller state:     [epoch, phase, mig_shard, mig_dst, assign0,
                       assign1, migs_done, fin_seen, 0...]
Client state:         [epoch, acked, 0, 0, assign0, assign1, 0...]
Assignments pack 4 bits per shard: shards 0-3 in assign0, 4-7 in
assign1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..check.history import OK_OK, OP_USER, pack_shard_own
from ..engine.core import (
    KIND_KILL, KIND_RESTART, HistorySpec, StateContract, Workload, get_col,
    retry_token_attempt, retry_token_op, set_col, set_cols, user_kind,
)
from ..engine.rng import M32

# history op codes (check.shard_coverage reads these)
OP_SHARD_WRITE = OP_USER  # commit: key = shard, arg = version
OP_SHARD_OWN = OP_USER + 1  # install: key = shard, arg = packed
#                             (epoch, group, version)
OP_ARMY_PUT = OP_USER + 2  # army apply: key = op id, arg = attempt

_H_INIT = 0
_H_PUT_T = 1  # at client: write/progress timer
_H_WRITE = 2  # at primary: args = (shard, seq)
_H_REPL = 3  # at backup: args = (shard, ver)
_H_WRITE_OK = 4  # at client: args = (shard, seq)
_H_WRONG = 5  # at client: routed to a non-owner, refetch config
_H_CFG_REQ = 6  # at controller
_H_CFG = 7  # at client: args = (epoch, assign0, assign1)
_H_MIG_T = 8  # at controller: rebalance timer
_H_MIG_RETX = 9  # at controller: re-drive the open migration
_H_MIG_START = 10  # at src primary: args = (shard, new_epoch, dst)
_H_HANDOFF = 11  # at dst primary: args = (shard, new_epoch, ver)
_H_INSTALL_ACK = 12  # at controller: args = (shard, new_epoch)
_H_RELEASE = 13  # at src primary: args = (shard, new_epoch)
_H_FIN = 14  # at controller: client done
_H_AREQ = 15  # at client: army op arrival, army mode
_H_APROBE = 16  # at controller: army probe
_H_ARESP = 17  # at client: army response

CONTROLLER = 0
CLIENT = 1

_C_EPOCH, _C_PHASE, _C_MIG_S, _C_MIG_D = 0, 1, 2, 3
_C_A0, _C_A1, _C_DONE, _C_FIN = 4, 5, 6, 7
# client columns; column 3 is the last army op applied plus one, the
# exactly-once dedup floor
_K_EPOCH, _K_ACKED, _K_APPLIED = 0, 1, 3

_P_KILL_AT = 0
_P_KILL_WHO = 1
_P_REVIVE = 2

VER_CAP = (1 << 16) - 1
EPOCH_CAP = 255
_A_MASK = 0xFFFF  # packed-assignment word bound (4 shards x 4 bits)


def _initial_assign(n_shards: int, n_groups: int) -> tuple[int, int]:
    """Initial shard -> group map, packed: shard s starts at s % G."""
    a0 = a1 = 0
    for s in range(n_shards):
        g = s % n_groups
        if s < 4:
            a0 |= g << (4 * s)
        else:
            a1 |= g << (4 * (s - 4))
    return a0, a1


def make_shardkv(
    n_groups: int = 4,
    group_size: int = 3,
    n_shards: int = 8,
    writes: int = 16,
    n_migs: int = 4,
    put_ms: int = 25,
    mig_ms: int = 70,
    retx_ms: int = 40,
    chaos: bool = True,
    record: bool = False,
    hist_capacity: int | None = None,
    bug: "bool | str" = False,
    army: bool = False,
    army_probes: int = 1,
) -> Workload:
    """The sharded-KV workload; ``record=True`` records writes and
    installs, ``bug=True`` plants the lost-shard mutant and ``army=True``
    adds the client-army handlers. ``bug="noidem"`` plants the
    non-idempotent retried-put mutant instead: the army apply skips its
    exactly-once floor, so every delivered attempt applies and records
    (``check.exactly_once`` sees it, ``shard_coverage`` does not). It
    needs ``record=True`` and ``army=True``."""
    if bug not in (False, True, "noidem"):
        raise ValueError(
            f"bug must be False, True (lost-shard) or 'noidem' "
            f"(non-idempotent retried put), got {bug!r}"
        )
    if bug and not record:
        raise ValueError(
            "bug plants a fault only histories can see; it requires "
            "record=True (otherwise nothing would ever detect it)"
        )
    if bug == "noidem" and not army:
        raise ValueError(
            "bug='noidem' lives in the army apply path; it requires "
            "army=True"
        )
    if army_probes < 1:
        raise ValueError(f"army_probes must be >= 1, got {army_probes}")
    G, R, S = n_groups, group_size, n_shards
    if not 1 <= S <= 8:
        raise ValueError(f"n_shards must be in [1, 8] (packed 4-bit "
                         f"assignment words), got {S}")
    if not 1 <= G <= 15:
        raise ValueError(f"n_groups must be in [1, 15] (4-bit group "
                         f"ids), got {G}")
    n = 2 + G * R
    width = max(2 * S + 1, 8)  # the controller's scalars need cols 0..7
    c_frozen = 2 * S
    a0_init, a1_init = _initial_assign(S, G)

    def _group_of(a0, a1, s):
        """Shard -> group from the packed words."""
        return (torch.where(s < 4, a0, a1) >> ((s & 3) * 4)) & 0xF

    def _primary_of(g):
        return 2 + g * R

    def _shard(ctx):
        return ctx.args[:, 0].clamp(0, S - 1)

    def _unfreeze(st, s):
        return st[:, c_frozen] & (_A_MASK ^ (1 << s))

    def on_init(ctx):
        eb = ctx.emits()
        is_client = ctx.node == CLIENT
        eb.after(mig_ms * 1_000_000, user_kind(_H_MIG_T), CONTROLLER,
                 when=ctx.node == CONTROLLER)
        eb.after(put_ms * 1_000_000, user_kind(_H_PUT_T), CLIENT, when=is_client)
        if chaos:
            # kill a random PRIMARY mid-run
            who = 2 + ctx.draw.user_int(0, G, _P_KILL_WHO) * R
            at = ctx.draw.user_int(20_000_000, 300_000_000, _P_KILL_AT)
            revive = ctx.draw.user_int(100_000_000, 600_000_000, _P_REVIVE)
            eb.after(at, KIND_KILL, 0, (who,), when=is_client)
            eb.after(at + revive, KIND_RESTART, 0, (who,), when=is_client)
        return ctx.state, eb.build()

    def on_put_t(ctx):
        # stop-and-wait client: one outstanding write, retried until
        # acked; write k targets shard k % S
        st = ctx.state
        done = st[:, _K_ACKED] >= writes
        seq = torch.clamp(st[:, _K_ACKED] + 1, max=VER_CAP)
        s = seq % S
        g = _group_of(st[:, _C_A0], st[:, _C_A1], s)
        eb = ctx.emits()
        eb.send(_primary_of(g), user_kind(_H_WRITE), (s, seq), when=~done)
        eb.send(CONTROLLER, user_kind(_H_FIN), when=done)
        eb.after(put_ms * 1_000_000, user_kind(_H_PUT_T), CLIENT)
        return ctx.state, eb.build()

    def on_write(ctx):
        # serve iff this group owns the shard and it is not frozen for an
        # open migration; anything else redirects the client
        s = _shard(ctx)
        seq = ctx.args[:, 1].clamp(0, VER_CAP)
        st = ctx.state
        owned = get_col(st, S + s) > 0
        frozen = ((st[:, c_frozen] >> s) & 1) > 0
        serving = owned & ~frozen
        fresh = serving & (seq > get_col(st, s))
        eb = ctx.emits()
        if record:
            eb.record(OP_SHARD_WRITE, s, seq, ok=OK_OK, when=fresh)
        eb.send(CLIENT, user_kind(_H_WRITE_OK), (s, seq), when=serving)
        eb.send(CLIENT, user_kind(_H_WRONG), (s,), when=~serving)
        # replicate the committed version inside the group
        base = 2 + torch.div(ctx.node - 2, R, rounding_mode="floor") * R
        for i in range(1, R):
            eb.send(base + i, user_kind(_H_REPL), (s, seq), when=fresh)
        return set_col(st, s, seq, fresh), eb.build()

    def on_repl(ctx):
        s = _shard(ctx)
        v = ctx.args[:, 1].clamp(0, VER_CAP)
        st = ctx.state
        return set_col(st, s, v, v > get_col(st, s)), ctx.emits().build()

    def on_write_ok(ctx):
        seq = ctx.args[:, 1].clamp(0, VER_CAP)
        new = ctx.state.clone()
        new[:, _K_ACKED] = torch.maximum(ctx.state[:, _K_ACKED], seq)
        return new, ctx.emits().build()

    def on_wrong(ctx):
        eb = ctx.emits()
        eb.send(CONTROLLER, user_kind(_H_CFG_REQ))
        return ctx.state, eb.build()

    def on_cfg_req(ctx):
        st = ctx.state
        eb = ctx.emits()
        eb.send(CLIENT, user_kind(_H_CFG), (st[:, _C_EPOCH], st[:, _C_A0], st[:, _C_A1]))
        return ctx.state, eb.build()

    def on_cfg(ctx):
        e = ctx.args[:, 0].clamp(0, EPOCH_CAP)
        a0 = ctx.args[:, 1].clamp(0, _A_MASK)
        a1 = ctx.args[:, 2].clamp(0, _A_MASK)
        st = ctx.state
        new = set_cols(st, e > st[:, _K_EPOCH], {_K_EPOCH: e, _C_A0: a0, _C_A1: a1})
        return new, ctx.emits().build()

    def _mig_start_row(eb, st, when):
        """(Re)drive the open migration: an idempotent MIG_START to the
        shard's current owner."""
        s = st[:, _C_MIG_S]
        src = _group_of(st[:, _C_A0], st[:, _C_A1], s)
        new_ep = torch.clamp(st[:, _C_EPOCH] + 1, max=EPOCH_CAP)
        eb.send(_primary_of(src), user_kind(_H_MIG_START),
                (s, new_ep, st[:, _C_MIG_D]), when=when)

    def on_mig_t(ctx):
        st = ctx.state
        more = st[:, _C_DONE] < n_migs
        start = (st[:, _C_PHASE] == 0) & more
        s = st[:, _C_DONE] % S
        dst = (_group_of(st[:, _C_A0], st[:, _C_A1], s) + 1) % G
        new = set_cols(st, start, {_C_PHASE: 1, _C_MIG_S: s, _C_MIG_D: dst})
        eb = ctx.emits()
        _mig_start_row(eb, new, start)
        eb.after(retx_ms * 1_000_000, user_kind(_H_MIG_RETX), CONTROLLER, when=start)
        eb.after(mig_ms * 1_000_000, user_kind(_H_MIG_T), CONTROLLER, when=more)
        return new, eb.build()

    def on_mig_retx(ctx):
        # re-drive the migration until the install is confirmed
        st = ctx.state
        open_ = st[:, _C_PHASE] == 1
        eb = ctx.emits()
        _mig_start_row(eb, st, open_)
        eb.after(retx_ms * 1_000_000, user_kind(_H_MIG_RETX), CONTROLLER, when=open_)
        return ctx.state, eb.build()

    def on_mig_start(ctx):
        s = _shard(ctx)
        new_ep = ctx.args[:, 1].clamp(0, EPOCH_CAP)
        dst = ctx.args[:, 2].clamp(0, G - 1)
        st = ctx.state
        owned = get_col(st, S + s) > 0
        eb = ctx.emits()
        if bug is True:
            # the planted lost-shard mutant: "handoff sent" counts as
            # "migration done", so the source wipes the shard at once and
            # answers a retried MIG_START from the wiped state
            eb.send(_primary_of(dst), user_kind(_H_HANDOFF),
                    (s, new_ep, get_col(st, s)))
            new = set_col(st, s, torch.zeros_like(s), owned)
            new = set_col(new, S + s, torch.zeros_like(s), owned)
        else:
            # freeze and hand off; keep the shard until RELEASE
            eb.send(_primary_of(dst), user_kind(_H_HANDOFF),
                    (s, new_ep, get_col(st, s)), when=owned)
            new = set_cols(st, owned, {c_frozen: st[:, c_frozen] | (1 << s)})
        return new, eb.build()

    def on_handoff(ctx):
        s = _shard(ctx)
        new_ep = ctx.args[:, 1].clamp(0, EPOCH_CAP)
        v = ctx.args[:, 2].clamp(0, VER_CAP)
        st = ctx.state
        fresh = get_col(st, S + s) < new_ep
        ver_new = torch.maximum(get_col(st, s), v)
        # installing also clears a stale frozen bit for the shard
        new = set_col(st, s, ver_new, fresh)
        new = set_col(new, S + s, new_ep, fresh)
        new = set_cols(new, fresh, {c_frozen: _unfreeze(st, s)})
        eb = ctx.emits()
        if record:
            my_group = torch.div(ctx.node - 2, R, rounding_mode="floor")
            eb.record(
                OP_SHARD_OWN, s,
                pack_shard_own(new_ep, my_group, torch.clamp(ver_new, max=VER_CAP)),
                ok=OK_OK, when=fresh,
            )
        # always ack (idempotent): a lost ack must not wedge the migration
        eb.send(CONTROLLER, user_kind(_H_INSTALL_ACK), (s, new_ep))
        return new, eb.build()

    def on_install_ack(ctx):
        s = _shard(ctx)
        e = ctx.args[:, 1].clamp(0, EPOCH_CAP)
        st = ctx.state
        match = (
            (st[:, _C_PHASE] == 1) & (s == st[:, _C_MIG_S])
            & (e == torch.clamp(st[:, _C_EPOCH] + 1, max=EPOCH_CAP))
        )
        src = _group_of(st[:, _C_A0], st[:, _C_A1], s)
        # the new assignment: shard s moves to the migration's group
        sh = (s & 3) * 4
        g = st[:, _C_MIG_D].clamp(0, G - 1)
        keep = _A_MASK ^ (0xF << sh)
        low = s < 4
        new = set_cols(st, match, {
            _C_A0: torch.where(low, (st[:, _C_A0] & keep) | (g << sh), st[:, _C_A0]),
            _C_A1: torch.where(low, st[:, _C_A1], (st[:, _C_A1] & keep) | (g << sh)),
            _C_EPOCH: e,
            _C_PHASE: 0,
            _C_DONE: torch.clamp(st[:, _C_DONE] + 1, max=EPOCH_CAP),
        })
        eb = ctx.emits()
        eb.send(_primary_of(src), user_kind(_H_RELEASE), (s, e), when=match)
        eb.send(CLIENT, user_kind(_H_CFG),
                (new[:, _C_EPOCH], new[:, _C_A0], new[:, _C_A1]), when=match)
        eb.halt(when=(new[:, _C_FIN] > 0) & (new[:, _C_DONE] >= n_migs))
        return new, eb.build()

    def on_release(ctx):
        # drop the frozen source copy: the only place a source forgets
        # a shard
        s = _shard(ctx)
        st = ctx.state
        frozen = ((st[:, c_frozen] >> s) & 1) > 0
        new = set_col(st, s, torch.zeros_like(s), frozen)
        new = set_col(new, S + s, torch.zeros_like(s), frozen)
        new = set_cols(new, frozen, {c_frozen: _unfreeze(st, s)})
        return new, ctx.emits().build()

    def on_fin(ctx):
        st = ctx.state
        new = st.clone()
        new[:, _C_FIN] = 1
        eb = ctx.emits()
        eb.halt(when=st[:, _C_DONE] >= n_migs)
        return new, eb.build()

    init = np.zeros((n, width), np.int32)
    init[CONTROLLER, _C_EPOCH] = 1
    init[CONTROLLER, _C_A0] = a0_init
    init[CONTROLLER, _C_A1] = a1_init
    init[CLIENT, _K_EPOCH] = 1
    init[CLIENT, _C_A0] = a0_init
    init[CLIENT, _C_A1] = a1_init
    for s in range(S):
        init[2 + (s % G) * R, S + s] = 1  # initial owners at epoch 1

    hist = None
    if record:
        # the army term covers the default client_army (256 ops) at 4
        # deliveries each
        cap = (
            2 * writes + 4 * n_migs + 16 + (1024 if army else 0)
            if hist_capacity is None else hist_capacity
        )
        hist = HistorySpec(capacity=cap, max_records=1)
    name = "shardkv"
    if record:
        if bug == "noidem":
            name += "-noidem"
        else:
            name += "-bug" if bug else "-record"

    def on_areq(ctx):
        # an army op arrives at the client: an exactly-once put. Ops are
        # offered in increasing id order, so `op >= floor` admits each
        # once and swallows repeated and reordered older deliveries
        op_id = retry_token_op(ctx.args[:, 0])
        att = retry_token_attempt(ctx.args[:, 0])
        st = ctx.state
        if bug == "noidem":
            # the planted mutant: every delivery applies and records, so
            # a retry whose first attempt did land applies the op twice
            applied = torch.ones_like(op_id, dtype=torch.bool)
        else:
            applied = op_id >= st[:, _K_APPLIED]
        new = set_cols(st, applied, {_K_APPLIED: torch.clamp(op_id + 1, 0, VER_CAP)})
        eb = ctx.emits()
        if record:
            eb.record(OP_ARMY_PUT, op_id, att, ok=OK_OK, when=applied)
        eb.lat_start(op_id)
        eb.send(CONTROLLER, user_kind(_H_APROBE), (op_id, army_probes - 1))
        return new, eb.build()

    def on_aprobe(ctx):
        eb = ctx.emits()
        eb.send(CLIENT, user_kind(_H_ARESP), (ctx.args[:, 0], ctx.args[:, 1]))
        return ctx.state, eb.build()

    def on_aresp(ctx):
        op_id, left = ctx.args[:, 0], ctx.args[:, 1]
        eb = ctx.emits()
        eb.send(CONTROLLER, user_kind(_H_APROBE), (op_id, left - 1), when=left > 0)
        eb.lat_end(op_id, when=left == 0)
        return ctx.state, eb.build()

    handlers = (
        on_init, on_put_t, on_write, on_repl, on_write_ok, on_wrong,
        on_cfg_req, on_cfg, on_mig_t, on_mig_retx, on_mig_start,
        on_handoff, on_install_ack, on_release, on_fin,
    )
    if army:
        name += "-army"
        handlers += (on_areq, on_aprobe, on_aresp)

    def _cov(ns, now):
        """Protocol coverage (Workload.cov_features): the migration edge
        the controller is on and the fleet-wide shard ownership count."""
        ctl = ns[:, CONTROLLER]
        ep = torch.clamp(ctl[:, _C_EPOCH], max=255).to(torch.int64) & M32
        ph = torch.clamp(ctl[:, _C_PHASE], 0, 1).to(torch.int64)
        ms = torch.clamp(ctl[:, _C_MIG_S], 0, 7).to(torch.int64)
        f1 = ep | (ph << 8) | (ms << 9) | (1 << 20)
        owned = sum((ns[:, 2 + g * R, S:2 * S] > 0).sum(1) for g in range(G))
        f2 = torch.clamp(owned.to(torch.int64), max=63) | (1 << 21)
        return ((f1, True), (f2, True))

    # per-column range contracts (the JAX package's): versions and
    # controller scalars share the low columns across roles, so each
    # column declares the hull; everything here is a bounded counter
    def _sc(col):
        if col < S:  # shard versions
            hi = VER_CAP
        elif col < 2 * S:  # per-shard ownership epochs
            hi = EPOCH_CAP
        elif col == c_frozen:
            hi = (1 << S) - 1
        else:
            hi = 1
        if col <= _C_FIN:
            hi = max(hi, VER_CAP)
        return StateContract(col, 0, hi, "counter")

    return Workload(
        name=name,
        n_nodes=n,
        state_width=width,
        handlers=handlers,
        handler_names=(
            "init", "put_t", "write", "repl", "write_ok", "wrong",
            "cfg_req", "cfg", "mig_t", "mig_retx", "mig_start", "handoff",
            "install_ack", "release", "fin",
        ) + (("areq", "aprobe", "aresp") if army else ()),
        # widest: on_write = ok + wrong + (R-1) replications; on_init =
        # the two timers + 2 chaos rows
        max_emits=max(R + 1, 6),
        init_state=init,
        # the largest timer a handler arms (the JAX package's bound)
        delay_bound_ns=max(put_ms * 1_000_000, mig_ms * 1_000_000, retx_ms * 1_000_000,
                           900_000_000),
        state_contracts=tuple(_sc(c) for c in range(width)),
        args_words=3,
        # disk-backed servers: every column survives a restart
        durable_cols=tuple(range(width)),
        draw_purposes=(_P_KILL_AT, _P_KILL_WHO, _P_REVIVE) if chaos else (),
        history=hist,
        cov_features=_cov,
        lat_markers=1 if army else 0,
        model_params=(
            ("n_groups", n_groups),
            ("group_size", group_size),
            ("n_shards", n_shards),
            ("writes", writes),
            ("n_migs", n_migs),
            ("put_ms", put_ms),
            ("mig_ms", mig_ms),
            ("retx_ms", retx_ms),
            ("chaos", chaos),
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
    op_base: int = 0,
    retry=None,
):
    """A :class:`chaos.ClientArmy` bound to shardkv's client surface
    (``make_shardkv(army=True)``): ops arrive at the client node, apply
    an exactly-once put and probe the controller. ``retry`` (a
    ``chaos.RetryPolicy``) makes the engine re-send ops that see no
    response in time (``plan.retry_spec()``)."""
    from ..chaos.plan import ClientArmy

    return ClientArmy(
        node=CLIENT,
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
    kw = dict(pool_size=64, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
    return [
        ("shardkv/plain", make_shardkv(), kw),
        ("shardkv/record", make_shardkv(record=True), kw),
        ("shardkv/army", make_shardkv(army=True), kw),
    ]


# The certification horizon of the column contracts: migrations and write windows are sim-milliseconds;
# 300 sim-seconds leaves an order of magnitude of slack (the JAX
# package's value).
ABSINT_HORIZON_NS = 300 * 1_000_000_000


def absint_entries():
    """The range checks' entry points: :func:`lint_entries` rows with the
    horizon, ``(tag, workload, engine-config kwargs, horizon ns)``."""
    return [(tag, wl, kw, ABSINT_HORIZON_NS) for tag, wl, kw in lint_entries()]
