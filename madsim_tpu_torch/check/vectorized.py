"""Whole-batch history checkers: one numpy pass over every seed at once.

A copy of the JAX package's ``madsim_tpu/check/vectorized.py`` (numpy only):
the torch port imports nothing of that package, whose ``check``
loads JAX through its device screens.

The linearizability checker (check/linearize.py) is exact but per-seed;
these detectors trade precision for a cost model that matches the
batched engine — O(S·H) array passes over the raw history columns (plus
a loop over the distinct clients/keys present, a small constant for the
in-repo models). Each returns an ``(S,)`` boolean array, True = clean,
i.e. exactly the ``history_invariant`` contract of
``engine.search_seeds``.

Scope (documented assumptions, not silent ones):

* **Versioned registers.** ``monotonic_reads`` / ``read_your_writes`` /
  ``stale_reads`` assume writes to a key carry strictly increasing
  int32 versions (kvchaos: the write seq). "Fresher" is then decidable
  per-record without a search. Non-versioned histories belong to the
  linearizability checker.
* ``monotonic_reads`` is invoke-interval aware (pipelined reads that
  legally complete out of order are tolerated); the response-order pass
  survives as the opt-in ``monotonic_reads_strict``.
* **FIFO invoke/response pairing** per (client, op, key), exact for
  clients with one outstanding op per key (all in-repo models) — same
  rule and same caveat as ``BatchHistory.ops``.
* Seeds whose history buffer overflowed are *not* judged here: callers
  (``search_seeds``) quarantine them via ``hist_drop``; these passes
  simply see the stored prefix.

This module is the **authoritative oracle**: every detector also
exists as a device-resident jnp kernel (check/device.py) whose
verdicts must match these bit for bit — the rank-matching guard paths
(paired invoke / bare response / malformed invoke-after) are pinned
per detector by the oracle table in tests/test_check_device.py, so a
change here without a matching kernel change fails the identity pins.
"""

from __future__ import annotations

import numpy as np

from .history import (
    COL_ARG,
    COL_CLIENT,
    COL_KEY,
    COL_OK,
    COL_OP,
    OK_FAIL,
    OK_OK,
    OK_PENDING,
    OP_READ,
    OP_WRITE,
    SHARD_EPOCH_SHIFT,
    SHARD_GROUP_MASK,
    SHARD_GROUP_SHIFT,
    SHARD_VER_MASK,
    BatchHistory,
)

__all__ = [
    "monotonic_reads",
    "monotonic_reads_strict",
    "read_your_writes",
    "stale_reads",
    "election_safety",
    "recovery_safety",
    "lease_safety",
    "shard_coverage",
    "exactly_once",
    "collapse_retries",
]

_MIN = np.int64(-(2**62))  # "no prior write" floor sentinel


def _cols(h: BatchHistory):
    valid = h.valid()
    return (
        valid,
        h.col(COL_OP),
        h.col(COL_KEY),
        h.col(COL_ARG).astype(np.int64),
        h.col(COL_CLIENT),
        h.col(COL_OK),
    )


def monotonic_reads_strict(h: BatchHistory, read_op: int = OP_READ) -> np.ndarray:
    """Per (client, key): successive successful read values never
    decrease **in response order**. Pure response-order property — no
    pairing needed — but UNSOUND for pipelined reads: two reads open
    concurrently may legally complete out of order, and this pass flags
    that. Opt-in for clients known to issue one read at a time; the
    default :func:`monotonic_reads` is the invoke-interval-aware form
    (the ROADMAP soundness fix)."""
    valid, op, key, arg, client, ok = _cols(h)
    m = valid & (op == read_op) & (ok == OK_OK)
    s_dim, h_dim = m.shape
    if h_dim == 0:
        return np.ones(s_dim, bool)
    # sort each seed's rows by (client, key), stable → buffer (= time)
    # order within each group; masked rows sort to a sentinel group
    big = np.int64(2**31)
    c_sort = np.where(m, client.astype(np.int64), big)
    k_sort = np.where(m, key.astype(np.int64), big)
    order = np.lexsort((k_sort, c_sort), axis=-1)
    cs = np.take_along_axis(c_sort, order, axis=1)
    ks = np.take_along_axis(k_sort, order, axis=1)
    vs = np.take_along_axis(np.where(m, arg, 0), order, axis=1)
    ms = np.take_along_axis(m, order, axis=1)
    same = (
        ms[:, 1:] & ms[:, :-1]
        & (cs[:, 1:] == cs[:, :-1]) & (ks[:, 1:] == ks[:, :-1])
    )
    viol = same & (vs[:, 1:] < vs[:, :-1])
    return ~viol.any(axis=1)


def _read_floor_violations(
    h: BatchHistory, read_op: int, write_op: int, own_writes_only: bool
) -> np.ndarray:
    """Shared core of read_your_writes / stale_reads: a successful read
    must return at least the newest version whose write had completed
    before the read was *invoked* (writes by the same client only, or by
    anyone). Floors are sampled at the read's invoke record and carried
    to its response by FIFO rank matching, so a write completing while
    the read is in flight never false-flags."""
    valid, op, key, arg, client, ok = _cols(h)
    s_dim, h_dim = valid.shape
    if h_dim == 0:
        return np.ones(s_dim, bool)
    rows = np.arange(s_dim)[:, None]
    w_resp = valid & (op == write_op) & (ok == OK_OK)
    r_inv = valid & (op == read_op) & (ok == OK_PENDING)
    r_resp = valid & (op == read_op) & (ok == OK_OK)
    viol = np.zeros(s_dim, bool)
    keys = np.unique(key[r_resp | r_inv | w_resp])
    clients = np.unique(client[r_resp | r_inv])

    def _excl_floor(sel_w):
        # exclusive running max of completed write versions, i.e. the
        # floor as of each row's dispatch
        wval = np.where(sel_w, arg, _MIN)
        excl = np.empty_like(wval)
        excl[:, 0] = _MIN
        np.maximum.accumulate(wval[:, :-1], axis=1, out=excl[:, 1:])
        return excl

    for k in keys:
        kw = w_resp & (key == k)
        if not own_writes_only:
            excl = _excl_floor(kw)  # client-independent: hoist
        for c in clients:
            if own_writes_only:
                excl = _excl_floor(kw & (client == c))
            inv = r_inv & (key == k) & (client == c)
            resp = r_resp & (key == k) & (client == c)
            # FIFO rank matching: the r-th response pairs the r-th invoke
            inv_rank = np.cumsum(inv, axis=1) - inv
            resp_rank = np.cumsum(resp, axis=1) - resp
            floor_by_rank = np.full((s_dim, h_dim + 1), _MIN)
            idx_by_rank = np.full((s_dim, h_dim + 1), h_dim)
            inv_slot = np.where(inv, inv_rank, h_dim)
            floor_by_rank[rows, inv_slot] = np.where(inv, excl, _MIN)
            idx_by_rank[rows, inv_slot] = np.where(
                inv, np.arange(h_dim)[None, :], h_dim
            )
            resp_slot = np.where(resp, resp_rank, h_dim)
            floor = floor_by_rank[rows, resp_slot]
            inv_idx = idx_by_rank[rows, resp_slot]
            own = np.arange(h_dim)[None, :]
            # three response shapes, by the rank-matched invoke's index:
            #   earlier invoke  -> floor sampled at the invoke (paired op)
            #   NO invoke ever  -> a bare/instantaneous event (history.py
            #     convention: invoke == response), so the floor as of its
            #     OWN buffer position applies — writes completed before
            #     the record are completed before the op
            #   invoke AFTER    -> malformed interleaving; no constraint
            #     (under-flag instead of false-flag)
            floor = np.where(
                inv_idx <= own, floor, np.where(inv_idx == h_dim, excl, _MIN)
            )
            viol |= (resp & (arg < floor)).any(axis=1)
    return ~viol


def monotonic_reads(h: BatchHistory, read_op: int = OP_READ) -> np.ndarray:
    """Per (client, key): a successful read returns no older a version
    than the newest read **by the same client completed before this read
    was invoked** — the monotonic-reads session guarantee, invoke-
    interval aware. Pipelined reads (several open at once on one
    session) may legally complete out of order and are NOT flagged;
    instantaneous read events (no invoke record) are ordered by their
    buffer position. This is the floor construction of
    :func:`stale_reads` with completed same-client reads as the floor
    source, so it inherits the FIFO invoke/response pairing contract.
    The old response-order pass survives as
    :func:`monotonic_reads_strict` (opt-in; unsound for pipelined
    reads)."""
    return _read_floor_violations(h, read_op, read_op, own_writes_only=True)


def read_your_writes(
    h: BatchHistory, read_op: int = OP_READ, write_op: int = OP_WRITE
) -> np.ndarray:
    """A client's successful read returns no older a version than its
    own newest write completed before the read was invoked."""
    return _read_floor_violations(h, read_op, write_op, own_writes_only=True)


def stale_reads(
    h: BatchHistory, read_op: int = OP_READ, write_op: int = OP_WRITE
) -> np.ndarray:
    """Linearizable-read form: a successful read returns no older a
    version than the newest write completed (by *any* client) before
    the read was invoked. On a system that routes reads through the
    authority for the key, a flagged seed means a committed write's
    effect vanished — the lost-write detector."""
    return _read_floor_violations(h, read_op, write_op, own_writes_only=False)


def recovery_safety(
    h: BatchHistory, sync_op: int, recover_op: int
) -> np.ndarray:
    """Crash-recovery safety: a restarted node never regresses durably
    synced state.

    The workload records a successful ``sync_op`` event whenever a sync
    COMMITS a state change (arg = the new durable value, e.g. a log
    length — raftlog's ``OP_SYNCED``) and a ``recover_op`` event when a
    restarted node comes back up (arg = the value it recovered —
    ``OP_RECOVER``). A seed is flagged when any recover's arg is below
    the arg of the SAME client's (node's) latest earlier sync record.

    The floor is the LAST sync, not the running max: a newer-term
    leader may legitimately truncate a follower's log, and the
    truncated-then-synced length is exactly what a crash must recover
    to. Under correct fsync placement this holds even through torn-
    write faults (a tear only loses *uncommitted* bytes); a lying disk
    (chaos ``SYNC_LOSS`` windows) violates it by design — the detector
    doubles as the positive control that the fault injection works.
    Buffer order is dispatch order (the engine appends at dispatch), so
    "earlier" needs no timestamps.
    """
    valid, op, key, arg, client, ok = _cols(h)
    s_dim, h_dim = valid.shape
    if h_dim == 0:
        return np.ones(s_dim, bool)
    sync_m = valid & (op == sync_op) & (ok == OK_OK)
    rec_m = valid & (op == recover_op) & (ok == OK_OK)
    viol = np.zeros(s_dim, bool)
    if not rec_m.any() or not sync_m.any():
        return ~viol
    idx_row = np.broadcast_to(np.arange(h_dim)[None, :], valid.shape)
    for c in np.unique(client[rec_m]):
        sm = sync_m & (client == c)
        # index of the latest sync at-or-before each buffer slot
        # (running max over marked indices; -1 = no sync yet)
        last = np.maximum.accumulate(np.where(sm, idx_row, -1), axis=1)
        floor = np.take_along_axis(
            np.where(sm, arg, 0), np.maximum(last, 0), axis=1
        )
        rm = rec_m & (client == c)
        viol |= (rm & (last >= 0) & (arg < floor)).any(axis=1)
    return ~viol


def lease_safety(h: BatchHistory, serve_op: int, lease_op: int) -> np.ndarray:
    """Lease-service safety (models/leasekv.py): no operation is served
    through an expired lease, and expiry respects the skew-adjusted TTL
    contract.

    The workload records the lease LIFECYCLE on ``lease_op`` — a grant
    or renewal as ``OK_OK`` with arg = the granted deadline (the
    server's own clock, ms), an expiry as ``OK_FAIL`` with arg = the
    server's local clock at expiry — and every served operation on
    ``serve_op``/``OK_OK``, all keyed by lease id. A seed is flagged
    when:

    1. a serve's latest earlier lifecycle record (same lease) is an
       expiry — the lease was dead and no re-grant intervened, or
    2. an expiry's clock arg is below the latest earlier grant's
       deadline arg — the lease died before its own server's clock
       reached the deadline it was granted (the TTL contract is stated
       on the server's LOCAL clock, so honest skew never flags; only a
       server expiring early against itself does).

    A serve with no earlier lifecycle record constrains nothing
    (under-flag, not false-flag). Buffer order is dispatch order and
    all three record kinds come from the single lease server, so
    "earlier" is the server's own event order — no timestamps needed.
    """
    valid, op, key, arg, client, ok = _cols(h)
    s_dim, h_dim = valid.shape
    if h_dim == 0:
        return np.ones(s_dim, bool)
    life = valid & (op == lease_op)
    grant = life & (ok == OK_OK)
    expire = life & (ok == OK_FAIL)
    serve = valid & (op == serve_op) & (ok == OK_OK)
    viol = np.zeros(s_dim, bool)
    if not life.any():
        return ~viol
    idx_row = np.broadcast_to(np.arange(h_dim)[None, :], valid.shape)
    for k in np.unique(key[life | serve]):
        lm = life & (key == k)
        em = expire & (key == k)
        # clause 1: index of the latest lifecycle record at-or-before
        # each slot (inclusive accumulate — a serve row is never itself
        # a lifecycle row, so inclusive == strictly earlier)
        last_l = np.maximum.accumulate(np.where(lm, idx_row, -1), axis=1)
        last_is_exp = np.take_along_axis(
            em.astype(np.int64), np.maximum(last_l, 0), axis=1
        ) > 0
        sm = serve & (key == k)
        viol |= (sm & (last_l >= 0) & last_is_exp).any(axis=1)
        # clause 2: expiry clock vs the latest earlier grant's deadline
        gm = grant & (key == k)
        last_g = np.maximum.accumulate(np.where(gm, idx_row, -1), axis=1)
        gfloor = np.take_along_axis(
            np.where(gm, arg, 0), np.maximum(last_g, 0), axis=1
        )
        viol |= (em & (last_g >= 0) & (arg < gfloor)).any(axis=1)
    return ~viol


def shard_coverage(h: BatchHistory, own_op: int, write_op: int) -> np.ndarray:
    """Shard-migration safety (models/shardkv.py): every shard is owned
    by at most one group per config epoch, and no committed write is
    lost across a migration.

    The workload records every install on ``own_op``/``OK_OK`` (key =
    shard, arg = the packed (epoch, group, adopted-version) word —
    ``history.pack_shard_own``) and every committed write on
    ``write_op``/``OK_OK`` (key = shard, arg = the version; versions
    must fit ``SHARD_VER_MASK``). A seed is flagged when:

    1. two install records share (shard, epoch) with different groups —
       a double-served range, or
    2. an install's adopted version is below some committed write
       earlier in the history for that shard — a lost range: the
       handoff shipped state that predates a committed write.

    Buffer order is dispatch order (deterministic across the fleet), so
    "earlier" is well-defined without timestamps; a write committed
    *while* a handoff is legally in flight cannot exist in the clean
    protocol (the source freezes before handing off), which is exactly
    why clause 2 is stated over plain buffer order.
    """
    valid, op, key, arg, client, ok = _cols(h)
    s_dim, h_dim = valid.shape
    if h_dim == 0:
        return np.ones(s_dim, bool)
    own = valid & (op == own_op) & (ok == OK_OK)
    write = valid & (op == write_op) & (ok == OK_OK)
    epoch = arg >> SHARD_EPOCH_SHIFT
    group = (arg >> SHARD_GROUP_SHIFT) & SHARD_GROUP_MASK
    ver = arg & SHARD_VER_MASK
    # clause 1: pairwise (shard, epoch) with different groups
    pair = own[:, :, None] & own[:, None, :]
    same_key = key[:, :, None] == key[:, None, :]
    same_ep = epoch[:, :, None] == epoch[:, None, :]
    diff_g = group[:, :, None] != group[:, None, :]
    viol = (pair & same_key & same_ep & diff_g).any(axis=(1, 2))
    # clause 2: per shard, installs vs the running max committed
    # version (inclusive accumulate — an install row is never itself a
    # write row, so inclusive == strictly earlier)
    if own.any() and write.any():
        for k in np.unique(key[own | write]):
            wm = write & (key == k)
            wmax = np.maximum.accumulate(np.where(wm, arg, _MIN), axis=1)
            om = own & (key == k)
            viol |= (om & (wmax > _MIN) & (ver < wmax)).any(axis=1)
    return ~viol


def exactly_once(h: BatchHistory, apply_op: int) -> np.ndarray:
    """At-most-once application (the client-retry safety property,
    models/shardkv.py army puts): no operation is applied twice by the
    state machine.

    The workload records every APPLY — the moment a delivery actually
    mutates state, not the delivery itself — on ``apply_op``/``OK_OK``
    with key = the op id (retry attempt bits stripped; the arg may
    carry the attempt for forensics, it is not judged). A seed is
    flagged when two apply records share (client, key): the same
    logical op took effect more than once, which is exactly what a
    modeled retry (chaos.RetryPolicy) turns from impossible into
    routine the moment an apply path is not idempotent. A correctly
    deduplicating state machine produces zero duplicates by
    construction no matter how aggressively the policy re-sends.

    Pairwise over the history buffer (the election_safety cost shape) —
    sized for op streams of hundreds of records, not millions.
    """
    valid, op, key, arg, client, ok = _cols(h)
    m = valid & (op == apply_op) & (ok == OK_OK)
    s_dim, h_dim = m.shape
    if h_dim == 0:
        return np.ones(s_dim, bool)
    pair = m[:, :, None] & m[:, None, :]
    same_key = key[:, :, None] == key[:, None, :]
    same_client = client[:, :, None] == client[:, None, :]
    off_diag = ~np.eye(h_dim, dtype=bool)[None, :, :]
    return ~(pair & same_key & same_client & off_diag).any(axis=(1, 2))


def collapse_retries(h: BatchHistory) -> BatchHistory:
    """Collapse retried invokes into one invocation interval per op.

    A model that records an invoke per DELIVERY (one per retry attempt)
    gives the FIFO invoke/response pairing several pending invokes for
    one logical op: the response then pairs the oldest attempt — which
    is the correct interval (latency clocks span first attempt ->
    final response) — but every later attempt's invoke lingers as a
    spurious pending op, and the floor detectors
    (:func:`read_your_writes` / :func:`stale_reads` /
    :func:`monotonic_reads`) would rank-match some FUTURE response to
    it, skewing intervals. This pass rewrites the history so each
    (client, op, key) carries at most one open invoke at a time: an
    invoke arriving while an earlier invoke of the same (client, op,
    key) is still unresponded is a retry re-send, and its record's op
    code is cleared to 0 (matching no detector mask — the row count
    and buffer order are untouched, so downstream index math is
    unchanged).

    The rule is stated over buffer (= dispatch) order: row j's invoke
    collapses iff an earlier invoke of the same (client, op, key)
    exists with no response of that (client, op, key) between them.
    O(S·H²) pairwise, like the pairwise detectors; the device twin is
    ``check.device.collapse_retries_cols`` (bit-identical by
    construction — same masks, same formula).
    """
    valid, op, key, arg, client, ok = _cols(h)
    s_dim, h_dim = valid.shape
    if h_dim == 0:
        return h
    inv = valid & (ok == OK_PENDING)
    resp = valid & (ok != OK_PENDING)
    same = (
        (key[:, :, None] == key[:, None, :])
        & (client[:, :, None] == client[:, None, :])
        & (op[:, :, None] == op[:, None, :])
    )
    lower = np.tril(np.ones((h_dim, h_dim), bool), k=-1)[None, :, :]
    # per-row count of same-group responses strictly before it: two
    # rows of one group share a "segment" iff these counts are equal,
    # i.e. no group response lies between them
    rcnt = (same & lower & resp[:, None, :]).sum(axis=2)
    collapsed = (
        inv
        & (
            same & lower & inv[:, None, :]
            & (rcnt[:, :, None] == rcnt[:, None, :])
        ).any(axis=2)
    )
    word = np.array(h.word, copy=True)
    word[..., COL_OP] = np.where(collapsed, 0, word[..., COL_OP])
    return BatchHistory(
        word=word, t=h.t, count=h.count, drop=h.drop
    )


def election_safety(h: BatchHistory, elect_op: int) -> np.ndarray:
    """At most one winner per term: no two successful ``elect_op``
    records share a key (term) with different args (winners). Pairwise
    over the history buffer — sized for election histories (capacity
    ~tens), not for long op streams."""
    valid, op, key, arg, client, ok = _cols(h)
    m = valid & (op == elect_op) & (ok == OK_OK)
    if m.shape[1] == 0:
        return np.ones(m.shape[0], bool)
    pair = m[:, :, None] & m[:, None, :]
    same_key = key[:, :, None] == key[:, None, :]
    diff_win = arg[:, :, None] != arg[:, None, :]
    return ~(pair & same_key & diff_win).any(axis=(1, 2))
