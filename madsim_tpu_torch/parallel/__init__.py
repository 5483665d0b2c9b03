"""Seed-axis sharding over a ``torch.distributed`` world.

Port of ``madsim_tpu/parallel``. The reference scales by running seeds
across OS threads, one runtime per thread; the JAX package shards the
seed batch over a device mesh. Here the mesh is a ``torch.distributed``
world, one process per card (NCCL) or per CPU process (gloo): every rank
advances its shard of the seed axis, and the ranks talk only when
results are folded or gathered — the simulations themselves are
independent along the seed axis.

* :func:`make_mesh` — the world as a :class:`Mesh`: its size, this rank,
  this rank's device and the process group. The seed axis splits
  rank-major: rank ``r`` holds rows ``r * local .. (r + 1) * local``, the
  order the JAX package's ``seed_sharding`` splits it in.
* :func:`shard_state` / :func:`shard_over_seeds` — this rank's rows of a
  batched state, and a batched program run on every rank's shard with
  the result state gathered back.
* The four merges (:func:`merge_coverage`, :func:`merge_metrics`,
  :func:`merge_latency`, :func:`merge_verdicts`) — without a mesh they
  fold one device's rows; with a mesh each rank passes ITS rows and gets
  the fold of the whole world's. NCCL has no bitwise-OR reduction, so the
  coverage fold all-gathers each rank's ``(CW,)`` local fold and ORs the
  ``D * CW`` words on the host (the JAX package's own design, and one
  path for both backends); metric and latency sums are int64
  ``all_reduce(SUM)``.
* :func:`shard_run_compacted` — the compacted runner on each rank's
  shard, the host results gathered.

A world is made by the caller: ``torch.distributed.init_process_group``
with its backend, world size, rank and an ``init_method`` (a
``file://`` store needs no port). Nothing here falls back: a collective
that fails raises.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

__all__ = [
    "Mesh",
    "fold_rows",
    "gather_rows",
    "make_mesh",
    "merge_coverage",
    "merge_latency",
    "merge_metrics",
    "merge_verdicts",
    "shard_over_seeds",
    "shard_run_compacted",
    "shard_state",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``torch.distributed`` world seen from one rank: ``size`` ranks,
    this one's ``rank`` and ``device``, and the process ``group`` (None
    is the default group)."""

    size: int
    rank: int
    device: torch.device
    group: object = None


def make_mesh(group=None, device=None) -> Mesh:
    """The initialized ``torch.distributed`` world (or ``group``) as a
    :class:`Mesh`. ``device`` is this rank's device: by default the
    current CUDA device, under NCCL (the card). A gloo world runs where
    the caller says, so it needs ``device`` (``"cpu"``). Raises if no
    process group is initialized."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process group "
            "(init_process_group with backend, world_size, rank and an "
            "init_method such as file:///path)"
        )
    if device is None:
        backend = dist.get_backend(group)
        if backend != "nccl":
            raise ValueError(
                f"make_mesh on a {backend} world needs device= (for example "
                f"'cpu'); only an NCCL world defaults to the card"
            )
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(size=dist.get_world_size(group), rank=dist.get_rank(group),
                device=torch.device(device), group=group)


def _local_rows(n: int, mesh: Mesh, what: str = "seeds") -> int:
    if n % mesh.size:
        raise ValueError(f"{n} {what} do not split over {mesh.size} devices")
    return n // mesh.size


def shard_state(state, mesh: Mesh):
    """This rank's rows of a batched ``SimState`` (every field leads with
    the seed axis), on the rank's device. The batch must split evenly."""
    from ..engine.core import STATE_FIELDS, SimState

    local = _local_rows(state.seed.shape[0], mesh)
    lo = mesh.rank * local
    return SimState(**{f: getattr(state, f)[lo:lo + local].to(mesh.device)
                       for f in STATE_FIELDS})


def gather_rows(t: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Concatenate every rank's ``t`` (equal shapes) along the seed axis,
    rank-major, on this rank's device. Without a mesh ``t`` itself; a
    world of one still runs the collective."""
    if mesh is None:
        return t
    import torch.distributed as dist

    shape = (t.shape[0] * mesh.size, *t.shape[1:])
    if t.numel() == 0:
        return t.new_empty(shape)
    # NCCL and gloo both move bytes: bool rows travel as uint8
    x = t.contiguous()
    x = x.to(torch.uint8) if x.dtype == torch.bool else x
    if x.is_cuda:
        out = x.new_empty((mesh.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=mesh.group)
    else:
        # gloo gathers into a list of tensors
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x, group=mesh.group)
        out = torch.cat(parts)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def fold_rows(rows: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """int64 sum of ``rows`` over the seed axis (dim 0), summed over the
    mesh's ranks too: a tensor on the rows' device, no host transfer."""
    total = rows.to(torch.int64).sum(0)
    if mesh is not None:
        import torch.distributed as dist

        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=mesh.group)
    return total


def shard_over_seeds(fn, mesh: Mesh):
    """``fn(state) -> state`` run on every rank's shard of the seed axis.

    The returned ``run(state)`` takes the whole batch (the same on every
    rank), runs ``fn`` on this rank's rows (:func:`shard_state`) with no
    communication inside the loop, and gathers the result rows back:
    every rank returns the whole batch's final state, equal to
    ``fn(state)`` unsharded (the seeds are independent)."""
    from ..engine.core import STATE_FIELDS, SimState

    def run(state):
        out = fn(shard_state(state, mesh))
        return SimState(**{f: gather_rows(getattr(out, f), mesh) for f in STATE_FIELDS})

    return run


def _to_tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device or "cpu")


def merge_coverage(bitmaps, mesh: Mesh | None = None) -> np.ndarray:
    """OR-fold per-seed coverage bitmaps (S, CW) into one (CW,) uint32 map.

    With a ``mesh`` each rank passes its own rows and every rank gets the
    fold of the world's: each rank ORs its rows on its device, the (CW,)
    local folds are all-gathered (``D * CW`` words) and ORed on the host
    — the collectives have no bitwise-OR reduction on NCCL."""
    bm = _to_tensor(bitmaps, mesh.device if mesh is not None else None)
    if bm.dim() != 2:
        raise ValueError(f"bitmaps must be (S, CW), got shape {tuple(bm.shape)}")
    bm = bm.to(torch.int64) & 0xFFFFFFFF
    # torch has no OR reduction: fold the rows pairwise, log2(S) rounds
    while bm.shape[0] > 1:
        if bm.shape[0] % 2:
            bm = torch.cat([bm, torch.zeros_like(bm[:1])])
        bm = bm[0::2] | bm[1::2]
    local = bm[0] if bm.shape[0] else bm.new_zeros(bm.shape[1])
    if mesh is not None:
        per_rank = gather_rows(local[None, :], mesh).cpu().numpy().astype(np.uint32)
        return np.bitwise_or.reduce(per_rank, axis=0)
    return local.cpu().numpy().astype(np.uint32)


def merge_metrics(met, mesh: Mesh | None = None) -> np.ndarray:
    """Sum per-seed fleet-metric columns (S, M) into (M,) int64 totals.

    int64 accumulation, so 32-bit per-seed counters cannot overflow the
    fleet sum. The ``MET_HALT_CODE`` slot is summed like any other
    (meaningless as a total; ``obs.fleet_reduce`` gives the halt-code
    split). A tensor is summed on its own device and only the (M,)
    totals reach the host; with a ``mesh`` each rank passes its rows and
    the totals are ``all_reduce(SUM)``-ed over the world."""
    m = _to_tensor(met, mesh.device if mesh is not None else None)
    if m.dim() != 2:
        raise ValueError(f"met must be (S, M), got shape {tuple(m.shape)}")
    return fold_rows(m, mesh).cpu().numpy()


def merge_latency(lat_hist, mesh: Mesh | None = None) -> np.ndarray:
    """Sum per-seed latency sketches (S, P, B) into (P, B) int64 totals.

    The ladder sketch is exactly mergeable (integer addition), so the
    sum of the shards equals the sum of the whole, bit for bit. A tensor
    is summed on its own device and only the (P, B) totals reach the
    host; with a ``mesh`` each rank passes its rows and the totals are
    ``all_reduce(SUM)``-ed over the world."""
    h = _to_tensor(lat_hist, mesh.device if mesh is not None else None)
    if h.dim() != 3:
        raise ValueError(f"lat_hist must be (S, P, B), got shape {tuple(h.shape)}")
    return fold_rows(h, mesh).cpu().numpy()


def merge_verdicts(ok, mesh: Mesh | None = None) -> np.ndarray:
    """Pack per-seed verdicts (S,) bool into (ceil(S/32),) uint32 words
    (``check.device.pack_verdicts``; unpack with
    ``check.device.unpack_verdicts``).

    With a ``mesh`` each rank packs its own rows (a multiple of 32, so
    the words align) and the words are all-gathered rank-major: every
    rank gets the world's words in seed order."""
    from ..check.device import pack_verdicts, verdict_words_to_numpy

    okb = _to_tensor(ok, mesh.device if mesh is not None else None).to(torch.bool)
    if okb.dim() != 1:
        raise ValueError(f"ok must be (S,), got shape {tuple(okb.shape)}")
    if mesh is None:
        return verdict_words_to_numpy(pack_verdicts(okb))
    if okb.shape[0] % 32:
        raise ValueError(
            f"{okb.shape[0] * mesh.size} verdicts do not split over {mesh.size} "
            f"devices in word-aligned (multiple-of-32) shards"
        )
    return verdict_words_to_numpy(gather_rows(pack_verdicts(okb), mesh))


def shard_run_compacted(
    wl,
    cfg,
    max_steps: int,
    mesh: Mesh,
    layout: str | None = None,
    time32: bool | None = None,
    shrink: int = 4,
    min_size: int = 2048,
    fields: tuple | None = None,
    latency=None,
    hist_screen=None,
    **taps,
):
    """Multi-rank form of :func:`engine.make_run_compacted`.

    Returns ``run(state) -> SimpleNamespace`` of per-original-seed numpy
    arrays, like the one-device runner. ``state`` is the whole batch (the
    same on every rank); each rank runs the one-device runner on its rows
    (the plain phase program on the CPU, one run-kernel launch on the
    card), with no communication in the hot loop, and the ranks' host
    results are gathered rank-major. Local phase boundaries fall at other
    steps than a one-device run's, so ``step`` is the shard's own phase
    schedule's; every other field equals the unsharded runner's, row for
    row. ``hist_screen`` screens and folds each rank's banks on its
    device, as the one-device runner does. ``layout`` and ``time32`` are
    accepted for the JAX package's signature (one lowering); ``taps`` go
    to ``make_run_compacted``."""
    del layout, time32
    import torch.distributed as dist

    from ..engine.compact import RESULT_FIELDS, make_run_compacted

    base = make_run_compacted(wl, cfg, max_steps, shrink=shrink, min_size=min_size,
                              fields=fields if fields is not None else RESULT_FIELDS,
                              latency=latency, hist_screen=hist_screen, **taps)

    def run(state) -> SimpleNamespace:
        mine = vars(base(shard_state(state, mesh)))
        parts = [None] * mesh.size
        dist.all_gather_object(parts, mine, group=mesh.group)
        return SimpleNamespace(**{f: np.concatenate([p[f] for p in parts]) for f in mine})

    return run
