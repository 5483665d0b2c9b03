"""Lease/watch KV service under chaos (the etcd-shaped batched model).

Port of ``madsim_tpu/models/leasekv.py``: one lease server, ``n_clients``
lease-holding clients and one watcher. Each client grants itself a TTL
lease at the server, keeps it alive with periodic keepalives, and
serves puts through it; the server's scan loop expires every lease
whose deadline passed on the server's own clock (``ctx.now``, the clock
plus the node's skew) and publishes each expiry to the watcher as a
sequenced event. The watcher appends in-order events and resyncs
against the server's stream head on a gap. Chaos kills a random client
mid-run and restarts it; the reborn client re-grants. The instance
halts when every client has finished its ``puts`` and the server has
seen each one's FIN. The fused kernel carries the same handlers as
device code (``csrc/model_leasekv.cuh``).

``record=True`` records the lease lifecycle: the server records every
grant (``OP_EXPIRE``/``OK_OK``, arg = the granted deadline on its own
ms clock), every expiry (``OP_EXPIRE``/``OK_FAIL``, arg = its ms clock)
and every served put (``OP_PUT``), and the watcher records in-order
stream events and explicit resyncs (``OP_WATCH_EVT``);
``check.lease_safety`` audits them. ``bug=True`` plants
grant-after-expiry: a keepalive on an expired lease resurrects it with
no grant record, so later puts are served through a lease the history
says is dead.

``ka_stop_ms`` (client 1 stalls its keepalives) needs ``chaos=False``
on the card: the kernel carries the default, record, bug and army
variants with the model's own chaos, and ``record=True, chaos=False``
with any ``ka_stop_ms`` or none (the library leasekv-record-nochaos).
``army=True`` opens the watcher as an open-loop client surface
(``client_army``): each op marks its invoke, runs ``army_probes``
read-only probe rounds against the server and marks its completion.

Node layout: [server 0, clients 1..C (lease id = node id), watcher C+1]
Server state:  [deadline_ms(lease 1) .. deadline_ms(lease C),
                wseq, fin_mask, expire_count]   (0 deadline = no lease)
Client state:  [granted, acked, fin, 0...]
Watcher state: [last_wseq, events, resyncs, 0...]
"""

from __future__ import annotations

import torch

from ..check.history import OK_FAIL, OK_OK, OP_USER
from ..engine.core import (
    KIND_KILL, KIND_RESTART, HistorySpec, StateContract, Workload, get_col, set_col,
    set_cols, user_kind,
)
from ..engine.rng import M32

# history op codes (check.lease_safety reads these)
OP_PUT = OP_USER  # serve: key = lease id, arg = put seq
OP_EXPIRE = OP_USER + 1  # lifecycle: OK_OK grant (arg = deadline_ms),
#                          OK_FAIL expiry (arg = server local ms)
OP_WATCH_EVT = OP_USER + 2  # stream: OK_OK in-order event (arg = wseq),
#                             OK_FAIL explicit resync (arg = new head)

_H_INIT = 0
_H_GRANT = 1  # at server: args = (lid,)
_H_GRANTED = 2  # at client
_H_KA_T = 3  # at client: keepalive timer
_H_KEEPALIVE = 4  # at server: args = (lid,)
_H_KA_REJ = 5  # at client: keepalive hit an expired lease
_H_SCAN = 6  # at server: expiry scan timer
_H_PUT_T = 7  # at client: put/progress timer
_H_PUT = 8  # at server: args = (lid, seq)
_H_PUT_OK = 9  # at client: args = (seq,)
_H_PUT_REJ = 10  # at client: put hit an expired lease
_H_FIN = 11  # at server: args = (lid,)
_H_WEVT = 12  # at watcher: args = (lid, wseq)
_H_RESYNC = 13  # at server: watcher stream-head request
_H_RESYNC_OK = 14  # at watcher: args = (wseq,)
_H_AREQ = 15  # at watcher: army op arrival, army mode
_H_APROBE = 16  # at server: army probe
_H_ARESP = 17  # at watcher: army response

SERVER = 0

_P_KILL_AT = 0
_P_KILL_WHO = 1
_P_REVIVE = 2

# deadlines are int32 milliseconds of the node's observed clock, which
# is clamped to this horizon (300 simulated seconds)
HORIZON_MS = 300_000
WSEQ_CAP = (1 << 16) - 1  # watch-stream sequence cap
EVT_CAP = (1 << 16) - 1  # cap on the event/resync/expiry counters


def _local_ms(now):
    """The handling node's observed clock in clamped int32 ms."""
    ms = torch.div(now, 1_000_000, rounding_mode="floor")
    return ms.clamp(0, HORIZON_MS).to(torch.int32)


def make_leasekv(
    n_clients: int = 3,
    puts: int = 6,
    ttl_ms: int = 120,
    ka_ms: int = 40,
    scan_ms: int = 20,
    put_ms: int = 30,
    ka_stop_ms: int | None = None,
    chaos: bool = True,
    record: bool = False,
    hist_capacity: int | None = None,
    bug: bool = False,
    army: bool = False,
    army_probes: int = 1,
) -> Workload:
    """The lease/watch workload; ``record=True`` records the lease
    lifecycle, ``bug=True`` plants grant-after-expiry and ``army=True``
    adds the client-army handlers at the watcher."""
    if bug and not record:
        raise ValueError(
            "bug=True plants a fault only histories can see; it requires "
            "record=True (otherwise nothing would ever detect it)"
        )
    if army_probes < 1:
        raise ValueError(f"army_probes must be >= 1, got {army_probes}")
    n = n_clients + 2
    watcher = n_clients + 1
    width = max(n_clients + 3, 4)
    c_wseq, c_fin_mask, c_exp_cnt = n_clients, n_clients + 1, n_clients + 2
    full_mask = (1 << n_clients) - 1

    def _lid(ctx):
        return ctx.args[:, 0].clamp(1, n_clients)

    def on_init(ctx):
        eb = ctx.emits()
        is_client = (ctx.node >= 1) & (ctx.node <= n_clients)
        # a client (re)grants its lease and starts its timers, at t=0
        # and again after a restart
        eb.send(SERVER, user_kind(_H_GRANT), (ctx.node,), when=is_client)
        eb.after(ka_ms * 1_000_000, user_kind(_H_KA_T), ctx.node, when=is_client)
        eb.after(put_ms * 1_000_000, user_kind(_H_PUT_T), ctx.node, when=is_client)
        eb.after(scan_ms * 1_000_000, user_kind(_H_SCAN), SERVER,
                 when=ctx.node == SERVER)
        if chaos:
            is_watcher = ctx.node == watcher
            who = ctx.draw.user_int(1, 1 + n_clients, _P_KILL_WHO)
            at = ctx.draw.user_int(20_000_000, 300_000_000, _P_KILL_AT)
            revive = ctx.draw.user_int(100_000_000, 600_000_000, _P_REVIVE)
            eb.after(at, KIND_KILL, 0, (who,), when=is_watcher)
            eb.after(at + revive, KIND_RESTART, 0, (who,), when=is_watcher)
        return ctx.state, eb.build()

    def on_grant(ctx):
        lid = _lid(ctx)
        deadline = _local_ms(ctx.now) + ttl_ms
        new = set_col(ctx.state, lid - 1, deadline)
        eb = ctx.emits()
        if record:
            eb.record(OP_EXPIRE, lid, deadline, ok=OK_OK)
        eb.send(lid, user_kind(_H_GRANTED))
        return new, eb.build()

    def on_granted(ctx):
        new = ctx.state.clone()
        new[:, 0] = 1
        return new, ctx.emits().build()

    def on_ka_t(ctx):
        send = ctx.state[:, 0] > 0
        if ka_stop_ms is not None:
            # client 1 stalls: its keepalives stop once its own clock
            # passes the mark
            stalled = (ctx.node == 1) & (_local_ms(ctx.now) >= ka_stop_ms)
            send = send & ~stalled
        eb = ctx.emits()
        eb.send(SERVER, user_kind(_H_KEEPALIVE), (ctx.node,), when=send)
        eb.after(ka_ms * 1_000_000, user_kind(_H_KA_T), ctx.node)
        return ctx.state, eb.build()

    def on_keepalive(ctx):
        lid = _lid(ctx)
        renew = get_col(ctx.state, lid - 1) > 0
        if bug:
            # planted grant-after-expiry: the keepalive resurrects an
            # expired lease with no grant record
            renew = torch.ones_like(renew)
        new = set_col(ctx.state, lid - 1, _local_ms(ctx.now) + ttl_ms, renew)
        eb = ctx.emits()
        eb.send(lid, user_kind(_H_KA_REJ), when=~renew)
        return new, eb.build()

    def on_drop_lease(ctx):
        # the lease expired server-side (on_ka_rej, on_put_rej): drop to
        # ungranted; the put timer re-grants
        new = ctx.state.clone()
        new[:, 0] = 0
        return new, ctx.emits().build()

    def on_scan(ctx):
        # every lease whose deadline passed the server's own clock
        # expires now; each expiry publishes one sequenced event
        st = ctx.state
        now_ms = _local_ms(ctx.now)
        wseq = st[:, c_wseq]
        eb = ctx.emits()
        new = st.clone()
        fired = torch.zeros_like(wseq)
        for lid in range(1, n_clients + 1):
            d = st[:, lid - 1]
            exp = (d > 0) & (now_ms >= d)
            new[:, lid - 1] = torch.where(exp, 0, d)
            seq_i = torch.clamp(wseq + fired + 1, max=WSEQ_CAP)
            eb.send(watcher, user_kind(_H_WEVT), (lid, seq_i), when=exp)
            if record:
                eb.record(OP_EXPIRE, lid, now_ms, ok=OK_FAIL, when=exp)
            fired = fired + exp.to(torch.int32)
        new[:, c_wseq] = torch.clamp(wseq + fired, max=WSEQ_CAP)
        new[:, c_exp_cnt] = torch.clamp(st[:, c_exp_cnt] + fired, max=EVT_CAP)
        eb.after(scan_ms * 1_000_000, user_kind(_H_SCAN), SERVER)
        return new, eb.build()

    def on_put_t(ctx):
        # the client progress loop: re-grant if ungranted, else push the
        # next unacked put, else keep offering FIN
        st = ctx.state
        granted, acked = st[:, 0] > 0, st[:, 1]
        done = acked >= puts
        eb = ctx.emits()
        eb.send(SERVER, user_kind(_H_GRANT), (ctx.node,), when=~granted & ~done)
        eb.send(SERVER, user_kind(_H_PUT), (ctx.node, acked + 1), when=granted & ~done)
        eb.send(SERVER, user_kind(_H_FIN), (ctx.node,), when=done)
        eb.after(put_ms * 1_000_000, user_kind(_H_PUT_T), ctx.node)
        return ctx.state, eb.build()

    def on_put(ctx):
        lid = _lid(ctx)
        seq = ctx.args[:, 1].clamp(0, puts)
        live = get_col(ctx.state, lid - 1) > 0
        eb = ctx.emits()
        if record:
            eb.record(OP_PUT, lid, seq, ok=OK_OK, when=live)
        eb.send(lid, user_kind(_H_PUT_OK), (seq,), when=live)
        eb.send(lid, user_kind(_H_PUT_REJ), when=~live)
        return ctx.state, eb.build()

    def on_put_ok(ctx):
        seq = ctx.args[:, 0].clamp(0, puts)
        new = ctx.state.clone()
        new[:, 1] = torch.maximum(ctx.state[:, 1], seq)
        return new, ctx.emits().build()

    def on_fin(ctx):
        mask = ctx.state[:, c_fin_mask] | (1 << (_lid(ctx) - 1))
        new = ctx.state.clone()
        new[:, c_fin_mask] = mask
        eb = ctx.emits()
        eb.halt(when=mask == full_mask)
        return new, eb.build()

    def on_wevt(ctx):
        # in-order events append; a sequence gap triggers an explicit
        # resync against the server's stream head
        lid = ctx.args[:, 0].clamp(0, n_clients)
        seq = ctx.args[:, 1].clamp(0, WSEQ_CAP)
        st = ctx.state
        in_order = seq == st[:, 0] + 1
        gap = seq > st[:, 0] + 1
        new = set_cols(st, in_order, {
            0: seq, 1: torch.clamp(st[:, 1] + 1, max=EVT_CAP),
        })
        new = set_cols(new, gap, {2: torch.clamp(st[:, 2] + 1, max=EVT_CAP)})
        eb = ctx.emits()
        if record:
            eb.record(OP_WATCH_EVT, lid, seq, ok=OK_OK, when=in_order)
        eb.send(SERVER, user_kind(_H_RESYNC), (st[:, 0],), when=gap)
        return new, eb.build()

    def on_resync(ctx):
        eb = ctx.emits()
        eb.send(watcher, user_kind(_H_RESYNC_OK), (ctx.state[:, c_wseq],))
        return ctx.state, eb.build()

    def on_resync_ok(ctx):
        # adopt the stream head and record the explicit resync marker
        w = ctx.args[:, 0].clamp(0, WSEQ_CAP)
        adv = w > ctx.state[:, 0]
        eb = ctx.emits()
        if record:
            eb.record(OP_WATCH_EVT, 0, w, ok=OK_FAIL, when=adv)
        return set_cols(ctx.state, adv, {0: w}), eb.build()

    def on_areq(ctx):
        # an army op arrives at the watcher: mark its invoke and open a
        # session of probes against the server's stream head
        op_id = ctx.args[:, 0]
        eb = ctx.emits()
        eb.lat_start(op_id)
        eb.send(SERVER, user_kind(_H_APROBE), (op_id, army_probes - 1))
        return ctx.state, eb.build()

    def on_aprobe(ctx):
        eb = ctx.emits()
        eb.send(watcher, user_kind(_H_ARESP), (ctx.args[:, 0], ctx.args[:, 1]))
        return ctx.state, eb.build()

    def on_aresp(ctx):
        op_id, left = ctx.args[:, 0], ctx.args[:, 1]
        eb = ctx.emits()
        eb.send(SERVER, user_kind(_H_APROBE), (op_id, left - 1), when=left > 0)
        eb.lat_end(op_id, when=left == 0)
        return ctx.state, eb.build()

    hist = None
    if record:
        cap = (
            6 * n_clients * max(puts, 2) + 32
            if hist_capacity is None else hist_capacity
        )
        # widest recording dispatch: the scan records one expiry per lease
        hist = HistorySpec(capacity=cap, max_records=max(n_clients, 1))
    name = "leasekv"
    if record:
        name += "-bug" if bug else "-record"
    handlers = (
        on_init, on_grant, on_granted, on_ka_t, on_keepalive,
        on_drop_lease, on_scan, on_put_t, on_put, on_put_ok,
        on_drop_lease, on_fin, on_wevt, on_resync, on_resync_ok,
    )
    if army:
        name += "-army"
        handlers += (on_areq, on_aprobe, on_aresp)

    def _cov(ns, now):
        """Protocol coverage (Workload.cov_features): which leases are
        live, the expiry count and the watcher's stream lag."""
        live_bits = torch.zeros_like(ns[:, SERVER, 0], dtype=torch.int64)
        for lid in range(1, n_clients + 1):
            live_bits = live_bits | ((ns[:, SERVER, lid - 1] > 0).to(torch.int64) << lid)
        exp = torch.clamp(ns[:, SERVER, c_exp_cnt], max=15).to(torch.int64) & M32
        lag = torch.clamp(ns[:, SERVER, c_wseq] - ns[:, watcher, 0], 0, 15).to(torch.int64)
        f1 = live_bits | (exp << 8) | (1 << 16)
        f2 = lag | (1 << 17)
        return ((f1, True), (f2, True))

    # per-column range contracts (the JAX package's): the hull each
    # column is owed at step boundaries across every role that uses it;
    # deadline columns are "time", everything else a bounded counter
    def _sc(col):
        lo, hi, fam = 0, 1, "counter"
        ranges = []
        if col < n_clients:  # server deadline_ms for lease col+1
            ranges.append((0, HORIZON_MS + ttl_ms, "time"))
        if col == c_wseq:
            ranges.append((0, WSEQ_CAP, "counter"))
        if col == c_fin_mask:
            ranges.append((0, full_mask, "counter"))
        if col == c_exp_cnt:
            ranges.append((0, EVT_CAP, "counter"))
        if col == 0:  # client granted; watcher last_wseq
            ranges.append((0, max(1, WSEQ_CAP), "counter"))
        if col == 1:  # client acked; watcher events
            ranges.append((0, max(puts, EVT_CAP), "counter"))
        if col == 2:  # client fin; watcher resyncs
            ranges.append((0, EVT_CAP, "counter"))
        for rlo, rhi, rfam in ranges:
            lo, hi = min(lo, rlo), max(hi, rhi)
            fam = "time" if rfam == "time" else fam
        return StateContract(col, lo, hi, fam)

    return Workload(
        name=name,
        n_nodes=n,
        state_width=width,
        handlers=handlers,
        handler_names=(
            "init", "grant", "granted", "ka_t", "keepalive", "ka_rej",
            "scan", "put_t", "put", "put_ok", "put_rej", "fin", "wevt",
            "resync", "resync_ok",
        ) + (("areq", "aprobe", "aresp") if army else ()),
        # widest: the scan sends one watch event per lease + its timer;
        # on_init builds 3 client rows, the server's timer and 2 chaos rows
        max_emits=max(n_clients + 1, 6),
        # the largest timer a handler arms (the JAX package's bound)
        delay_bound_ns=max(ka_ms * 1_000_000, scan_ms * 1_000_000, put_ms * 1_000_000,
                           900_000_000),
        state_contracts=tuple(_sc(c) for c in range(width)),
        args_words=2,
        draw_purposes=(_P_KILL_AT, _P_KILL_WHO, _P_REVIVE) if chaos else (),
        history=hist,
        cov_features=_cov,
        lat_markers=1 if army else 0,
        model_params=(
            ("n_clients", n_clients),
            ("puts", puts),
            ("ttl_ms", ttl_ms),
            ("ka_ms", ka_ms),
            ("scan_ms", scan_ms),
            ("put_ms", put_ms),
            ("ka_stop_ms", ka_stop_ms),
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
    n_clients: int = 3,
    op_base: int = 0,
):
    """A :class:`chaos.ClientArmy` bound to leasekv's watcher
    (``make_leasekv(army=True)`` with the same ``n_clients``): ops arrive
    at the watcher and probe the server's stream head."""
    from ..chaos.plan import ClientArmy

    return ClientArmy(
        node=n_clients + 1,  # [server, clients 1..C, watcher C+1]
        kind=user_kind(_H_AREQ),
        n_ops=n_ops,
        t_min_ns=t_min_ns,
        t_max_ns=t_max_ns,
        op_base=op_base,
    )


def lint_entries():
    """The non-interference matrix's entry points (``lint.model_matrix``):
    ``(tag, workload, engine-config kwargs)``, the JAX package's rows."""
    kw = dict(pool_size=48, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
    return [
        ("leasekv/plain", make_leasekv(), kw),
        ("leasekv/record", make_leasekv(record=True), kw),
        ("leasekv/army", make_leasekv(army=True), kw),
    ]


# The certification horizon of the column contracts: lease TTLs and scan periods are sim-milliseconds;
# 300 sim-seconds leaves an order of magnitude of slack (the JAX
# package's value).
ABSINT_HORIZON_NS = 300 * 1_000_000_000


def absint_entries():
    """The range checks' entry points: :func:`lint_entries` rows with the
    horizon, ``(tag, workload, engine-config kwargs, horizon ns)``."""
    return [(tag, wl, kw, ABSINT_HORIZON_NS) for tag, wl, kw in lint_entries()]
