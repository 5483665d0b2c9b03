"""The history screens on the device: ``check/vectorized.py`` as torch
ops on the columns where the run left them.

Port of ``madsim_tpu/check/device.py``. The numpy detectors judge a
sweep only after every seed's history columns have crossed to the
host: ``hist_word`` (S, H, 5) int32 and ``hist_t`` (S, H) int64, then
serial numpy passes. Each detector here is restated as batched torch
ops over the same columns (and ``hist_count``/``hist_drop``), on the
tensors' own device, so the host receives a packed verdict word per 32
seeds instead of the columns. Two consumers:

* ``engine.search_seeds(device_check=...)``: the host reads the verdict
  words and the full histories of the flagged seeds only (the input of
  the exact Wing–Gong confirmation, ``check/linearize.py``);
* ``engine.make_run_compacted(hist_screen=...)``: each bank is screened,
  and for clean seeds the responded (invoke, response) pairs fold out of
  the banked columns (:func:`fold_verified`, counted in ``hist_fold``).

Verdicts are bit-identical to the numpy path. Each predicate is an
algebraic restatement (pairwise ``(C, H, H)`` masks over a chunk of C
seeds instead of per-(key, client) loops) of its ``check.vectorized``
function: the same floor construction, the same FIFO rank matching,
the same three response shapes (paired invoke, bare response, invoke
after the response), and the same quarantine (a seed whose buffer
dropped records is judged as an empty history). A flagged seed keeps
every record through the fold.

These are torch ops, not hand kernels: a CUDA tensor is screened on the
card by PyTorch's own kernels, a CPU tensor on the CPU. Nothing moves
between devices here. :func:`slo_breaches` is the latency detector of
``check/slo.py`` restated the same way. :func:`violation_cones` runs on
the host: it cuts each flagged seed's backward happens-before cone out
of a ``causal=True`` sweep's captured ring.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
    OP_USER,
    OP_WRITE,
    SHARD_EPOCH_SHIFT,
    SHARD_GROUP_MASK,
    SHARD_GROUP_SHIFT,
    SHARD_VER_MASK,
    BatchHistory,
)

__all__ = [
    "HistoryScreen",
    "as_screens",
    "collapse_retries_cols",
    "default_screens",
    "election_safety",
    "exactly_once",
    "fold_verified",
    "lease_safety",
    "monotonic_reads",
    "monotonic_reads_strict",
    "pack_verdicts",
    "pack_verdicts_host",
    "read_your_writes",
    "recovery_safety",
    "screen_ok",
    "screens_invariant",
    "shard_coverage",
    "slo_breaches",
    "stale_reads",
    "unpack_verdicts",
    "verdict_words_to_numpy",
    "violation_cones",
]

_MIN = -(2**62)  # "no prior write" floor sentinel (vectorized._MIN), int64

# seeds per chunk: the pairwise (C, H, H) masks are materialized per
# chunk, which bounds peak memory to chunk·H² elements however large the
# sweep. A pure evaluation schedule: verdicts are value-identical for
# any chunk size.
_CHUNK = 2048


def _cols(word):
    """(C, H, 5) int32 rows -> the five (C, H) columns, arg widened to
    int64 as numpy does."""
    return (
        word[..., COL_OP],
        word[..., COL_KEY],
        word[..., COL_ARG].to(torch.int64),
        word[..., COL_CLIENT],
        word[..., COL_OK],
    )


def _pair(x):
    """(C, H) -> (C, H, H) bool: ``[c, i, j]`` is ``x[c, i] == x[c, j]``."""
    return x[:, :, None] == x[:, None, :]


def _idx_valid(word, count):
    idx = torch.arange(word.shape[1], device=word.device)
    return idx, idx[None, :] < count[:, None]


def _clean(word):
    return torch.ones(word.shape[0], dtype=torch.bool, device=word.device)


def _last_at_or_before(cand, idx):
    """(C, H, H) candidate masks over [i, j] -> (C, H): for each row j
    the largest candidate i (at or before j by the mask), -1 if none."""
    return torch.where(cand, idx[None, :, None], -1).amax(dim=1)


def _floor_ok(word, count, read_op: int, write_op: int, own_only: bool):
    """Core of stale_reads / read_your_writes / monotonic_reads: the
    invoke-interval-aware floor check of
    ``vectorized._read_floor_violations``, restated pairwise.

    Every successful read response j is matched to the invoke of the
    same rank in its (client, key) read group, and its value must be at
    least the newest completed write version as of that invoke; as of
    its own buffer slot when the group has no invoke of that rank (a
    bare event); unconstrained when the matched invoke sits after it
    (malformed: under-flag, never false-flag). -> (C,) bool, True =
    clean."""
    h_dim = word.shape[1]
    if h_dim == 0:
        return _clean(word)
    idx, valid = _idx_valid(word, count)
    op, key, arg, client, ok = _cols(word)
    w_resp = valid & (op == write_op) & (ok == OK_OK)
    r_inv = valid & (op == read_op) & (ok == OK_PENDING)
    r_resp = valid & (op == read_op) & (ok == OK_OK)
    grp = _pair(client) & _pair(key)  # the (client, key) read group
    lt = idx[:, None] < idx[None, :]
    # rank of each invoke and response within its group: the count of
    # strictly earlier members of the same kind
    inv_rank = (lt & r_inv[:, :, None] & grp).sum(dim=1)
    resp_rank = (lt & r_resp[:, :, None] & grp).sum(dim=1)
    match = r_inv[:, :, None] & grp & (inv_rank[:, :, None] == resp_rank[:, None, :])
    has_inv = match.any(dim=1)
    # the first (the only) matching invoke, h_dim if none
    inv_idx = torch.where(match, idx[None, :, None], h_dim).amin(dim=1)
    # floor sample position: the invoke's slot, else the response's own
    pos = torch.where(has_inv, inv_idx, idx[None, :])
    sel_w = w_resp[:, :, None] & _pair(key)
    if own_only:
        sel_w = sel_w & _pair(client)
    before = idx[None, :, None] < pos[:, None, :]
    floor = torch.where(sel_w & before, arg[:, :, None], _MIN).amax(dim=1)
    floor = torch.where(has_inv & (inv_idx > idx[None, :]), _MIN, floor)
    return ~(r_resp & (arg < floor)).any(dim=1)


def _strict_ok(word, count, read_op: int):
    """``monotonic_reads_strict``: within a (client, key) group of
    successful reads, no later response returns less than any earlier
    one (a decreasing adjacent pair exists iff a decreasing pair
    does)."""
    if word.shape[1] == 0:
        return _clean(word)
    idx, valid = _idx_valid(word, count)
    op, key, arg, client, ok = _cols(word)
    m = valid & (op == read_op) & (ok == OK_OK)
    pair = (m[:, :, None] & m[:, None, :] & (idx[:, None] < idx[None, :])
            & _pair(client) & _pair(key))
    return ~(pair & (arg[:, None, :] < arg[:, :, None])).any(dim=(1, 2))


def _election_ok(word, count, elect_op: int):
    """``election_safety``: no two successful elect records share a key
    (term) with different args (winners)."""
    if word.shape[1] == 0:
        return _clean(word)
    _idx, valid = _idx_valid(word, count)
    op, key, arg, _client, ok = _cols(word)
    m = valid & (op == elect_op) & (ok == OK_OK)
    bad = m[:, :, None] & m[:, None, :] & _pair(key) & ~_pair(arg)
    return ~bad.any(dim=(1, 2))


def _recovery_ok(word, count, sync_op: int, recover_op: int):
    """``recovery_safety``: a recover record's arg is never below the
    same client's latest earlier sync arg (the last sync, not the
    running max)."""
    if word.shape[1] == 0:
        return _clean(word)
    idx, valid = _idx_valid(word, count)
    op, _key, arg, client, ok = _cols(word)
    sync_m = valid & (op == sync_op) & (ok == OK_OK)
    rec_m = valid & (op == recover_op) & (ok == OK_OK)
    cand = sync_m[:, :, None] & _pair(client) & (idx[:, None] <= idx[None, :])
    last = _last_at_or_before(cand, idx)
    at_last = cand & (idx[None, :, None] == last[:, None, :])
    floor = torch.where(at_last, arg[:, :, None], _MIN).amax(dim=1)
    return ~(rec_m & (last >= 0) & (arg < floor)).any(dim=1)


def _lease_ok(word, count, serve_op: int, lease_op: int):
    """``lease_safety``: no serve whose latest earlier lifecycle record
    of the same lease is an expiry, and no expiry below the latest
    earlier grant's deadline (a serve row is never a lifecycle row and
    an expiry never a grant, so at-or-before equals strictly-earlier,
    as numpy has it)."""
    if word.shape[1] == 0:
        return _clean(word)
    idx, valid = _idx_valid(word, count)
    op, key, arg, _client, ok = _cols(word)
    life = valid & (op == lease_op)
    grant = life & (ok == OK_OK)
    expire = life & (ok == OK_FAIL)
    serve = valid & (op == serve_op) & (ok == OK_OK)
    key_ab = _pair(key) & (idx[:, None] <= idx[None, :])
    # clause 1: the latest same-lease lifecycle record is an expiry
    cand = life[:, :, None] & key_ab
    last = _last_at_or_before(cand, idx)
    last_exp = _last_at_or_before(cand & expire[:, :, None], idx)
    c1 = serve & (last >= 0) & (last_exp == last)
    # clause 2: an expiry's clock below the latest earlier grant's deadline
    gcand = grant[:, :, None] & key_ab
    glast = _last_at_or_before(gcand, idx)
    at_glast = gcand & (idx[None, :, None] == glast[:, None, :])
    gfloor = torch.where(at_glast, arg[:, :, None], _MIN).amax(dim=1)
    c2 = expire & (glast >= 0) & (arg < gfloor)
    return ~(c1 | c2).any(dim=1)


def _shard_ok(word, count, own_op: int, write_op: int):
    """``shard_coverage``: no two installs share (shard, epoch) with
    different groups, and every install's adopted version covers the
    running max of earlier committed writes to its shard; the packed
    arg decoded in int64 as numpy does."""
    if word.shape[1] == 0:
        return _clean(word)
    idx, valid = _idx_valid(word, count)
    op, key, arg, _client, ok = _cols(word)
    own = valid & (op == own_op) & (ok == OK_OK)
    write = valid & (op == write_op) & (ok == OK_OK)
    epoch = arg >> SHARD_EPOCH_SHIFT
    group = (arg >> SHARD_GROUP_SHIFT) & SHARD_GROUP_MASK
    ver = arg & SHARD_VER_MASK
    same_key = _pair(key)
    # clause 1: double serve, one (shard, epoch) and two groups
    c1 = own[:, :, None] & own[:, None, :] & same_key & _pair(epoch) & ~_pair(group)
    # clause 2: lost range, the running max committed version per shard
    wcand = write[:, :, None] & same_key & (idx[:, None] <= idx[None, :])
    wmax = torch.where(wcand, arg[:, :, None], _MIN).amax(dim=1)
    c2 = own & (wmax > _MIN) & (ver < wmax)
    return ~(c1.any(dim=(1, 2)) | c2.any(dim=1))


def _exactly_once_ok(word, count, apply_op: int):
    """``exactly_once``: no two successful apply records share (client,
    key)."""
    h_dim = word.shape[1]
    if h_dim == 0:
        return _clean(word)
    _idx, valid = _idx_valid(word, count)
    op, key, _arg, client, ok = _cols(word)
    m = valid & (op == apply_op) & (ok == OK_OK)
    off_diag = ~torch.eye(h_dim, dtype=torch.bool, device=word.device)
    bad = m[:, :, None] & m[:, None, :] & _pair(key) & _pair(client) & off_diag
    return ~bad.any(dim=(1, 2))


def _chunked_seed_map(per_chunk, *cols):
    """``per_chunk(*cols)`` over the seed axis in ``_CHUNK``-seed slices
    (the last one shorter), outputs concatenated in seed order. One
    tensor or a tuple of them, as ``per_chunk`` returns."""
    s_dim = cols[0].shape[0]
    if s_dim <= _CHUNK:
        return per_chunk(*cols)
    parts = [per_chunk(*(c[lo:lo + _CHUNK] for c in cols))
             for lo in range(0, s_dim, _CHUNK)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def collapse_retries_cols(word, count):
    """Device twin of ``check.vectorized.collapse_retries``: (S, H, 5)
    int32 columns and (S,) counts -> the columns with every retry
    re-send invoke's op code cleared to 0 (row count and order
    untouched). An invoke collapses iff an earlier invoke of the same
    (client, op, key) exists with no response of that group between
    them: numpy's pairwise formula. Apply before :func:`screen_ok` when
    a model records one invoke per delivered retry."""
    if word.shape[1] == 0:
        return word

    def per_chunk(w, c):
        idx, valid = _idx_valid(w, c)
        op, key, _arg, client, okc = _cols(w)
        inv = valid & (okc == OK_PENDING)
        resp = valid & (okc != OK_PENDING)
        same = _pair(key) & _pair(client) & _pair(op)
        lower = idx[:, None] > idx[None, :]  # [j, i]: i strictly earlier
        rcnt = (same & lower & resp[:, None, :]).sum(dim=2)
        collapsed = inv & (
            same & lower & inv[:, None, :] & (rcnt[:, :, None] == rcnt[:, None, :])
        ).any(dim=2)
        out = w.clone()
        out[..., COL_OP] = torch.where(collapsed, 0, w[..., COL_OP])
        return out

    return _chunked_seed_map(per_chunk, word, count)


@dataclasses.dataclass(frozen=True)
class HistoryScreen:
    """One detector as batched torch ops, with its numpy oracle.

    Value-hashable (a frozen literal), so it can key a cache of built
    runners. Build instances through the module constructors
    (:func:`stale_reads` and the rest), which mirror the
    ``check.vectorized`` names and defaults.

    ``op_a``/``op_b`` are (read, write) for the floor detectors, (elect,
    -) for election safety, (sync, recover) for recovery safety, (serve,
    lease) for lease safety, (own, write) for shard coverage and (apply,
    -) for exactly-once: the positional ops of the numpy functions.
    """

    kind: str
    op_a: int = OP_READ
    op_b: int = OP_WRITE

    def __post_init__(self):
        if self.kind not in _KERNELS:
            raise ValueError(
                f"unknown screen kind {self.kind!r} "
                f"(one of {sorted(_KERNELS)})"
            )

    def seed_kernel(self, word, count):
        """Each seed's verdict over a chunk: (C, H, 5) int32 rows and
        (C,) counts -> (C,) bool, True = clean. :func:`screen_ok` runs
        it chunk by chunk."""
        return _KERNELS[self.kind](word, count, self)

    def host(self, h: BatchHistory) -> np.ndarray:
        """The numpy oracle: the ``check.vectorized`` function this
        screen ports, on a host :class:`BatchHistory`."""
        from . import vectorized as v

        fn = {
            "stale_reads": lambda: v.stale_reads(h, self.op_a, self.op_b),
            "read_your_writes": lambda: v.read_your_writes(h, self.op_a, self.op_b),
            "monotonic_reads": lambda: v.monotonic_reads(h, self.op_a),
            "monotonic_reads_strict": lambda: v.monotonic_reads_strict(h, self.op_a),
            "election_safety": lambda: v.election_safety(h, self.op_a),
            "recovery_safety": lambda: v.recovery_safety(h, self.op_a, self.op_b),
            "lease_safety": lambda: v.lease_safety(h, self.op_a, self.op_b),
            "shard_coverage": lambda: v.shard_coverage(h, self.op_a, self.op_b),
            "exactly_once": lambda: v.exactly_once(h, self.op_a),
        }[self.kind]
        return fn()


_KERNELS = {
    "stale_reads": lambda w, c, s: _floor_ok(w, c, s.op_a, s.op_b, own_only=False),
    "read_your_writes": lambda w, c, s: _floor_ok(w, c, s.op_a, s.op_b, own_only=True),
    "monotonic_reads": lambda w, c, s: _floor_ok(w, c, s.op_a, s.op_a, own_only=True),
    "monotonic_reads_strict": lambda w, c, s: _strict_ok(w, c, s.op_a),
    "election_safety": lambda w, c, s: _election_ok(w, c, s.op_a),
    "recovery_safety": lambda w, c, s: _recovery_ok(w, c, s.op_a, s.op_b),
    "lease_safety": lambda w, c, s: _lease_ok(w, c, s.op_a, s.op_b),
    "shard_coverage": lambda w, c, s: _shard_ok(w, c, s.op_a, s.op_b),
    "exactly_once": lambda w, c, s: _exactly_once_ok(w, c, s.op_a),
}


def stale_reads(read_op: int = OP_READ, write_op: int = OP_WRITE):
    """Lost-write screen: ``check.vectorized.stale_reads`` on the device."""
    return HistoryScreen("stale_reads", read_op, write_op)


def read_your_writes(read_op: int = OP_READ, write_op: int = OP_WRITE):
    return HistoryScreen("read_your_writes", read_op, write_op)


def monotonic_reads(read_op: int = OP_READ):
    """Invoke-interval-aware monotonic reads (the sound default)."""
    return HistoryScreen("monotonic_reads", read_op, read_op)


def monotonic_reads_strict(read_op: int = OP_READ):
    """Response-order monotonic reads (opt-in; unsound for pipelined
    reads, the ``check.vectorized`` caveat)."""
    return HistoryScreen("monotonic_reads_strict", read_op, read_op)


def election_safety(elect_op: int):
    return HistoryScreen("election_safety", elect_op, 0)


def recovery_safety(sync_op: int, recover_op: int):
    return HistoryScreen("recovery_safety", sync_op, recover_op)


def lease_safety(serve_op: int, lease_op: int):
    """Lease-service screen (models/leasekv.py): serve-after-expiry and
    early expiry."""
    return HistoryScreen("lease_safety", serve_op, lease_op)


def shard_coverage(own_op: int, write_op: int):
    """Shard-migration screen (models/shardkv.py): double serve and lost
    range."""
    return HistoryScreen("shard_coverage", own_op, write_op)


def exactly_once(apply_op: int):
    """At-most-once-apply screen (the client-retry safety property)."""
    return HistoryScreen("exactly_once", apply_op, 0)


def default_screens() -> tuple:
    """The generic screen set over the shared op namespace: the built-in
    detectors at their conventional ops. Real sweeps pass the model's
    own ops."""
    return (
        stale_reads(),
        read_your_writes(),
        monotonic_reads(),
        election_safety(OP_USER),
        recovery_safety(OP_USER + 2, OP_USER + 3),
    )


def as_screens(spec) -> tuple:
    """Normalize a screen spec (one screen or an iterable) to a tuple."""
    if isinstance(spec, HistoryScreen):
        return (spec,)
    screens = tuple(spec)
    if not screens or not all(isinstance(s, HistoryScreen) for s in screens):
        raise ValueError(
            f"device check must be a HistoryScreen or a non-empty "
            f"iterable of them, got {spec!r}"
        )
    return screens


def screen_ok(screens, word, t, count, drop):
    """Batched verdict on the columns' device: (S, H, 5) / (S, H) / (S,)
    / (S,) history columns -> (S,) bool, True = every screen clean.

    ``t`` rides along for symmetry with the column set (no screen reads
    clocks: buffer order is dispatch order). A seed whose buffer dropped
    records is judged as an empty history (clean), as ``search_seeds``
    quarantines it: its verdict is voided through ``hist_drop``."""
    del t
    screens = as_screens(screens)
    count = torch.where(drop > 0, 0, count)

    def per_chunk(w, c):
        ok = screens[0].seed_kernel(w, c)
        for s in screens[1:]:
            ok = ok & s.seed_kernel(w, c)
        return ok

    return _chunked_seed_map(per_chunk, word, count)


def screens_invariant(screens):
    """The host form of a screen set: a ``search_seeds``
    ``history_invariant`` running the numpy oracles, the reference arm
    of every device-against-host check."""
    screens = as_screens(screens)

    def invariant(h: BatchHistory) -> np.ndarray:
        ok = np.ones(len(h), bool)
        for s in screens:
            ok &= np.asarray(s.host(h), bool)
        return ok

    invariant.__name__ = "+".join(s.kind for s in screens)
    return invariant


# ---------------------------------------------------------------------------
# verdict words: the transfer format
# ---------------------------------------------------------------------------


def pack_verdicts(ok):
    """(S,) bool verdicts -> (ceil(S/32),) int64 words on the same
    device, each holding 32 bits (bit ``s % 32`` of word ``s // 32`` is
    seed s clean; pad bits 0). torch has no uint32 shift, so the words
    are int64 here and ``np.uint32`` at the host boundary
    (:func:`unpack_verdicts`)."""
    ok = torch.as_tensor(ok, dtype=torch.bool)
    pad = (-ok.shape[0]) % 32
    if pad:
        ok = torch.cat([ok, ok.new_zeros(pad)])
    shifts = torch.arange(32, dtype=torch.int64, device=ok.device)
    # distinct bit positions per word: the sum is the bitwise or
    return (ok.reshape(-1, 32).to(torch.int64) << shifts).sum(dim=1)


def verdict_words_to_numpy(words) -> np.ndarray:
    """:func:`pack_verdicts`' words on the host, as ``np.uint32``."""
    return words.cpu().numpy().astype(np.uint32)


def unpack_verdicts(words, n_seeds: int) -> np.ndarray:
    """Host inverse of :func:`pack_verdicts` -> (n_seeds,) bool; takes
    the words as numpy or as a tensor."""
    if isinstance(words, torch.Tensor):
        words = verdict_words_to_numpy(words)
    w = np.asarray(words, np.uint32)
    bits = (w[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    return bits.reshape(-1)[:n_seeds].astype(bool)


def pack_verdicts_host(ok) -> np.ndarray:
    """Numpy mirror of :func:`pack_verdicts`, to ``np.uint32`` words (for
    verdicts already on the host, such as the compacted runner's
    ``hist_ok``)."""
    ok = np.asarray(ok, bool)
    pad = (-ok.shape[0]) % 32
    if pad:
        ok = np.concatenate([ok, np.zeros((pad,), bool)])
    bits = ok.reshape(-1, 32).astype(np.uint32) << np.arange(32, dtype=np.uint32)[None, :]
    return bits.sum(axis=1, dtype=np.uint32)


# ---------------------------------------------------------------------------
# history prefix-compaction
# ---------------------------------------------------------------------------


def _fifo_unmatched(inv, resp, grp, idx):
    """Invokes left pending by the FIFO pairing of ``BatchHistory.ops``:
    each response closes the oldest still-open earlier invoke of its
    (client, op, key) group; a response with no open invoke is
    instantaneous and closes nothing. Sequential in the buffer position,
    so one pass per position over the chunk's seeds; the first open
    candidate is the least index among them, ``h_dim`` for none."""
    h_dim = inv.shape[1]
    matched = torch.zeros_like(inv)
    for j in range(h_dim):
        cand = inv & ~matched & grp[:, :, j] & (idx < j)
        first = torch.where(cand, idx, h_dim).amin(dim=1)
        # first == h_dim (no open invoke) marks nothing
        matched |= resp[:, j, None] & (idx[None, :] == first[:, None])
    return inv & ~matched


def fold_verified(word, t, count, drop, ok):
    """History prefix-compaction (``make_run_compacted``'s
    ``hist_screen`` fold): for seeds the screens judged clean, every
    response record and its FIFO-matched invoke fold out of the columns;
    only still-pending invokes stay, compacted to the front in buffer
    order, and the rows past them are zero. Returns ``(word2, t2,
    count2, fold)`` with ``fold`` the records folded per seed
    (``hist_fold``: count == count2 + fold always).

    A flagged seed (``ok`` False) or an overflowed one (``drop`` > 0)
    keeps every record verbatim (fold 0), so the exact confirmation
    always sees the full history."""
    if word.shape[1] == 0:
        return word, t, count, torch.zeros_like(count)

    def per_chunk(w, tt, c, d, okv):
        idx, valid = _idx_valid(w, c)
        op, key, _arg, client, okc = _cols(w)
        inv = valid & (okc == OK_PENDING)
        resp = valid & (okc != OK_PENDING)
        grp = _pair(client) & _pair(op) & _pair(key)
        keep_f = _fifo_unmatched(inv, resp, grp, idx)
        do_fold = okv & (d == 0)
        keep = torch.where(do_fold[:, None], keep_f, valid)
        # stable compaction: kept rows first, in their original order
        order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
        n_keep = keep.sum(dim=1).to(c.dtype)
        mask = idx[None, :] < n_keep[:, None]
        w2 = torch.where(mask[:, :, None], torch.take_along_dim(w, order[:, :, None], dim=1), 0)
        t2 = torch.where(mask, torch.take_along_dim(tt, order, dim=1), 0)
        return w2, t2, n_keep, c - n_keep

    return _chunked_seed_map(per_chunk, word, t, count, drop, ok)


def violation_cones(report, wl=None) -> dict:
    """Causal forensics over a device-screened search's escalation set.

    For every flagged seed in ``report.flagged_idx`` (the escalation of
    ``search_seeds(device_check=...)``), the backward happens-before cone
    (``obs.causal.causal_slice``) anchored at the seed's last completed
    history record, where the screen's verdict crystallized. The sweep
    must have run with ``causal=True`` and ``timeline_cap > 0``: the
    cone then rides the escalation for free, and the host confirmer
    narrates a small causal slice instead of the whole captured stream.

    Returns ``{seed_row: CausalCone}`` in flagged order. A flagged seed
    with no completed record anchors at its final dispatch.
    """
    from ..obs.causal import causal_slice

    if report.flagged_idx is None:
        raise ValueError(
            "report carries no escalation set — run the sweep with "
            "device_check=... so flagged seeds are identified"
        )
    if report.timeline is None:
        raise ValueError(
            "violation cones need the captured ring — run the sweep "
            "with timeline_cap > 0 (and causal=True)"
        )
    h = report.flagged_history
    cones = {}
    for j, row in enumerate(np.asarray(report.flagged_idx)):
        anchor = None
        for i in range(int(h.count[j]) - 1, -1, -1):
            if int(h.word[j, i, COL_OK]) != OK_PENDING:
                anchor = (int(h.t[j, i]), int(h.word[j, i, COL_CLIENT]))
                break
        cones[int(row)] = causal_slice(report.timeline, seed=int(row), anchor=anchor, wl=wl)
    return cones


# ---------------------------------------------------------------------------
# the latency detector
# ---------------------------------------------------------------------------


# the sketch's bucket edges, one copy per device: a device campaign's
# judge calls the screen every generation, and a copy from pageable host
# memory there would wait for the card
_EDGES: dict = {}


def _lat_edges(dev) -> torch.Tensor:
    from ..engine.core import LAT_EDGES_NS, host_to_device

    key = str(dev)
    if key not in _EDGES:
        _EDGES[key] = host_to_device(torch.from_numpy(LAT_EDGES_NS), dev)
    return _EDGES[key]


def slo_breaches(lat_hist, bound_ns: int, q: float = 0.99, min_ops: int = 16):
    """``check.slo.slo_breaches`` as torch ops on the sketches' device:
    (S, P, B) per-seed latency sketches -> (S,) bool, True where some
    window provably breaches (its quantile bucket's lower edge exceeds
    the bound), with the rank convention of
    ``obs.hist_quantile_bucket``."""
    from ..engine.core import N_LAT_BUCKETS

    if not 0.0 < q < 1.0:
        raise ValueError(f"q must be in (0, 1), got {q}")
    if min_ops < 1:
        raise ValueError(f"min_ops must be >= 1, got {min_ops}")
    h = torch.as_tensor(lat_hist).to(torch.int64)
    if h.dim() != 3 or h.shape[2] != N_LAT_BUCKETS:
        raise ValueError(
            f"lat_hist must be (S, P, {N_LAT_BUCKETS}), got shape {tuple(h.shape)}"
        )
    total = h.sum(-1)  # (S, P)
    # ceil(q * total) in float64, as numpy computes it
    rank = torch.ceil(q * total.to(torch.float64)).to(torch.int64).clamp(min=1)
    cum = h.cumsum(-1)
    # the first bucket whose cumulative count reaches the rank
    bucket = (cum < rank[..., None]).sum(-1)
    bucket = torch.where(total > 0, bucket, -1)
    edges = _lat_edges(h.device)
    bc = bucket.clamp(min=0)
    lo = torch.where(bc <= 0, 0, edges[(bc - 1).clamp(0, N_LAT_BUCKETS - 2)])
    breach = (total >= min_ops) & (bucket >= 0) & (lo > int(bound_ns))
    return breach.any(-1)
