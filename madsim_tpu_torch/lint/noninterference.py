"""Non-interference of the derived state, checked by perturbation.

The engine's observability columns (coverage, ``met``, the timeline
ring, the histories, the latency tap, the causal columns, and the disk
columns when the sync discipline is off: ``engine.derived_fields``)
carry a contract: the step may write them, but nothing computed from
them may reach a core ``SimState`` column, a draw or the trace fold.

The JAX package proves this statically, by tainting the derived inputs
of a traced jaxpr (``madsim_tpu/lint/noninterference.py``). The port
has no graph to taint: its step is eager torch, and its run kernel is
CUDA outside any graph. So the port checks the property dynamically,
on any runner — the plain step, the run kernel on the card, or the
kernel's step code built for the host with g++:

* run the state clean, in ``chunks`` equal calls;
* run it again for each perturbation seed, overwriting before every
  chunk each non-empty derived column with values drawn uniformly
  within its ``engine.column_contracts`` contract (clipped to the
  column's dtype), from an explicit ``torch.Generator`` on the state's
  device;
* require every column of ``engine.core_fields`` (the trace included)
  to equal the clean run's on every seed at every chunk boundary.

A value-identical edge (``step + met * 0``) is invisible to this check,
where the JAX taint walk sees it; in exchange the check covers code no
graph holds. :func:`plant_met_leak` is the live control: a real edge
from ``met`` into ``step``, which the check must report. The check also
holds the clean chunked run equal to one unchunked run (a runner that
reloads a chunk boundary differently would fail there first), and, with
``ranges=True``, every chunk boundary's state within its contracts
(``lint.absint.check_ranges``).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..engine.core import (
    STATE_FIELDS,
    EngineConfig,
    LatencySpec,
    SimState,
    Workload,
    column_contracts,
    core_fields,
    derived_fields,
    make_init,
    make_run_plain,
)
from ..engine.rng import M32
from .absint import _bounds, check_ranges

__all__ = [
    "BUILD_AXES",
    "NonInterferenceReport",
    "check_matrix",
    "check_noninterference",
    "model_matrix",
    "perturb_derived",
    "plant_met_leak",
]

# build-flag axes, the JAX package's: each turns one derived-column
# family (or all of them) on. History on/off and the disk discipline are
# model variants (record=, durable=), so they live in model_matrix.
BUILD_AXES = {
    "base": {},
    "metrics": dict(metrics=True),
    "timeline": dict(timeline_cap=8),
    "coverage": dict(cov_words=8),
    "hitcount": dict(cov_words=8, cov_hitcount=True),
    "latency": dict(latency=LatencySpec(ops=8, phases=2)),
    # the causal columns are swept with the ring on: the ring's banks
    # exist only with a ring to write into
    "causal": dict(causal=True, timeline_cap=8),
    "all": dict(
        metrics=True, timeline_cap=8, cov_words=8, cov_hitcount=True,
        latency=LatencySpec(ops=8, phases=2), causal=True,
    ),
}

# the flags make_init takes (the runner takes these and dup_rows)
_INIT_FLAGS = ("metrics", "cov_words", "timeline_cap", "cov_hitcount", "latency", "causal",
               "retry", "plan_slots")


@dataclasses.dataclass
class NonInterferenceReport:
    """Verdict of one perturbation check of a (workload, config, flags)."""

    workload: str
    config_hash: str
    entry: str  # the runner's name
    flags: dict  # the build flags, JSON-able
    derived: tuple  # the derived columns perturbed (non-empty ones)
    n_seeds: int
    n_steps: int
    chunks: int
    perturb_seeds: tuple
    # core field -> {"seeds", "first_seed", "chunk", "perturb_seed"}:
    # the first chunk boundary at which the field differed from the
    # clean run, how many seeds differed there and the first of them
    diffs: dict
    # fields where the clean chunked run differs from the unchunked one
    chunking: list
    # check_ranges findings at chunk boundaries, each with its
    # "chunk" and "perturb_seed" (None: the clean run)
    ranges: list = dataclasses.field(default_factory=list)
    uncertified: int = 0  # seed-boundaries past the horizon (not findings)
    horizon_ns: int = 0  # the contracts' certification horizon

    @property
    def ok(self) -> bool:
        return not self.diffs and not self.chunking and not self.ranges

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self), "derived": list(self.derived),
                "perturb_seeds": list(self.perturb_seeds), "ok": self.ok}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "NonInterferenceReport":
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls)}
        kw["derived"] = tuple(kw["derived"])
        kw["perturb_seeds"] = tuple(kw["perturb_seeds"])
        return cls(**kw)

    def summary(self) -> str:
        on = ", ".join(f"{k}={v}" for k, v in sorted(self.flags.items()) if v)
        what = (f"{self.workload} [{self.entry}] flags={{{on}}} {self.n_seeds} seeds x "
                f"{self.n_steps} steps in {self.chunks} chunks, contracts at a "
                f"{self.horizon_ns / 1e9:g} s horizon")
        if self.ok:
            return (f"OK   {what}: {len(self.derived)} derived columns perturbed under "
                    f"seeds {list(self.perturb_seeds)}, the core columns and the trace "
                    f"equal on every seed" + (f", {self.uncertified} uncertified"
                                              if self.uncertified else ""))
        lines = [f"LEAK {what}:"]
        for field, d in self.diffs.items():
            lines.append(f"  core column {field!r} differs on {d['seeds']} seeds (first "
                         f"{d['first_seed']}) after chunk {d['chunk']} under perturbation "
                         f"seed {d['perturb_seed']}")
        if self.chunking:
            lines.append(f"  the chunked clean run differs from the unchunked one in "
                         f"{self.chunking}")
        for r in self.ranges:
            lines.append(f"  {r['field']} outside [{r['lo']}, {r['hi']}] on {r['seeds']} "
                         f"seeds (first {r['first_seed']}; {r['min']}..{r['max']}) after "
                         f"chunk {r['chunk']} (perturbation seed {r['perturb_seed']})")
        return "\n".join(lines)


def _draw(contract, like: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Values uniform in ``contract`` clipped to ``like``'s dtype, in
    ``like``'s shape, from ``gen`` on ``like``'s device; a contract as
    wide as the word (a uint64 in int64) takes any bit pattern."""
    lo, hi, _whole = _bounds(contract, like.dtype)
    kw = dict(generator=gen, device=like.device, dtype=torch.int64)
    if hi - lo < (1 << 62):
        v = torch.randint(lo, hi + 1, like.shape, **kw)
    else:
        # a 64-bit word: two 32-bit halves, folded into [lo, hi]
        half = [torch.randint(0, 1 << 32, like.shape, **kw) for _ in range(2)]
        bits = half[0] | (half[1] << 32)
        span = hi - lo + 1
        v = bits if span >= 1 << 64 else lo + (bits & ((1 << 63) - 1)) % span
    return v.to(like.dtype)


def perturb_derived(state: SimState, fields, contracts: dict,
                    gen: torch.Generator) -> SimState:
    """``state`` with each non-empty column of ``fields`` overwritten by
    values drawn uniformly within its contract (``contracts``), clipped
    to its dtype, from ``gen``."""
    new = {}
    for f in fields:
        t = getattr(state, f)
        if t.numel():
            new[f] = _draw(contracts[f], t, gen).contiguous()
    return dataclasses.replace(state, **new)


def _differs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per seed, whether two columns differ anywhere (bool, on device)."""
    s = a.shape[0]
    if a.numel() == 0:
        return torch.zeros(s, dtype=torch.bool, device=a.device)
    return (a != b).reshape(s, -1).any(1)


def _json_flags(flags: dict) -> dict:
    out = {}
    for k, v in flags.items():
        if isinstance(v, LatencySpec):
            v = [v.ops, v.phases, v.phase_ns]
        elif dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        out[k] = v
    return out


def check_noninterference(
    wl: Workload,
    cfg: EngineConfig,
    *,
    run=make_run_plain,
    seeds,
    n_steps: int,
    chunks: int = 4,
    perturb_seeds: tuple = (1, 2),
    fields=None,
    ranges: bool = True,
    horizon_ns: int | None = None,
    device=None,
    **flags,
) -> NonInterferenceReport:
    """Check that the derived columns of ``wl`` never steer a run.

    ``run`` is the runner factory, called as ``run(wl, cfg, n, **run
    flags)`` and returning ``state -> state`` for ``n`` steps:
    ``make_run_plain`` (the default), ``make_run`` (the run kernel on a
    CUDA state), or a host build's runner. ``seeds`` are the seeds to
    make the initial state from (``make_init`` on ``device``, the card
    unless the caller asks for the CPU, with the init flags), or the
    initial :class:`SimState` itself. ``n_steps``
    is split into ``chunks`` equal calls; before each chunk of a
    perturbed run, ``fields`` (default ``derived_fields(wl)``) are
    overwritten within their contracts, from a ``torch.Generator`` on
    the state's device seeded with each of ``perturb_seeds``. With
    ``ranges``, every chunk boundary is held to the contracts
    (certification horizon ``horizon_ns``, default the config's).
    ``flags`` are the build flags (``metrics``, ``cov_words``,
    ``cov_hitcount``, ``timeline_cap``, ``latency``, ``causal``,
    ``retry``, ``dup_rows``; ``plan_slots`` for ``make_init``)."""
    if n_steps % chunks:
        raise ValueError(f"n_steps={n_steps} does not split into {chunks} equal chunks")
    run_flags = {k: v for k, v in flags.items() if k != "plan_slots"}
    if isinstance(seeds, SimState):
        state0 = seeds
    else:
        init_flags = {k: v for k, v in flags.items() if k in _INIT_FLAGS}
        state0 = make_init(wl, cfg, device=device, **init_flags)(
            np.asarray(seeds, np.uint64))
    dev = state0.device
    s = state0.seed.shape[0]
    contracts = column_contracts(wl, cfg, horizon_ns=horizon_ns)
    fields = tuple(derived_fields(wl) if fields is None else fields)
    perturbed = tuple(f for f in fields if getattr(state0, f).numel())
    core = core_fields(wl)
    chunk = run(wl, cfg, n_steps // chunks, **run_flags)
    range_rows, uncert = [], 0

    def held(st, c, p):
        nonlocal uncert
        if not ranges:
            return
        rc = check_ranges(st, contracts)
        uncert += rc.uncertified
        range_rows.extend({**r, "chunk": c, "perturb_seed": p} for r in rc.findings)

    # the clean run, its core columns kept at every chunk boundary
    clean, st = [], state0
    for c in range(chunks):
        st = chunk(st)
        clean.append({f: getattr(st, f) for f in core})
        held(st, c, None)
    whole = run(wl, cfg, n_steps, **run_flags)(state0)
    chunking = [f for f in STATE_FIELDS
                if bool(_differs(getattr(whole, f), getattr(st, f)).any())]
    del whole

    diffs: dict = {}
    for p in perturb_seeds:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(p))
        st = state0
        for c in range(chunks):
            st = chunk(perturb_derived(st, fields, contracts, gen))
            held(st, c, p)
            masks = torch.stack([_differs(getattr(st, f), clean[c][f]) for f in core])
            counts = masks.sum(1).tolist()
            first = torch.argmax(masks.to(torch.int64), dim=1).tolist()
            for i, f in enumerate(core):
                if counts[i] and f not in diffs:
                    diffs[f] = {"seeds": int(counts[i]), "first_seed": int(first[i]),
                                "chunk": c, "perturb_seed": int(p)}
    return NonInterferenceReport(
        workload=wl.name, config_hash=cfg.hash(),
        entry=getattr(run, "__name__", type(run).__name__),
        flags=_json_flags(flags), derived=perturbed, n_seeds=s, n_steps=n_steps,
        chunks=chunks, perturb_seeds=tuple(int(p) for p in perturb_seeds), diffs=diffs,
        chunking=chunking, ranges=range_rows, uncertified=uncert,
        horizon_ns=int(contracts["now"].hi),
    )


def plant_met_leak(step_fn):
    """The live control: ``step_fn`` (``state -> state``) followed by
    ``step += met[:, MET_SENT] & 1`` (uint32 in int64), a real data edge
    from a derived column into the RNG coordinate.
    :func:`check_noninterference` must report ``step``. Needs a state
    with the fleet counters (``metrics=True``)."""
    from ..engine.core import MET_SENT

    def mutant(st: SimState) -> SimState:
        out = step_fn(st)
        if out.met.shape[1] <= MET_SENT:
            raise ValueError("plant_met_leak needs a state with metrics=True")
        leak = out.met[:, MET_SENT].to(torch.int64) & 1
        return dataclasses.replace(out, step=(out.step + leak) & M32)

    return mutant


def model_matrix() -> list:
    """(tag, workload, config, horizon ns) rows of the six recorded
    models, from each model module's ``absint_entries()``: its
    ``lint_entries()`` with the model's certification horizon
    (``ABSINT_HORIZON_NS``), which bounds the contracts' time columns and
    marks the seeds past it uncertified."""
    from ..models import kvchaos, leasekv, paxos, raft, raftlog, shardkv

    entries = []
    for mod in (raft, kvchaos, paxos, raftlog, leasekv, shardkv):
        for tag, wl, cfg_kw, horizon in mod.absint_entries():
            entries.append((tag, wl, EngineConfig(**cfg_kw), horizon))
    return entries


def check_matrix(cells, *, seeds, n_steps: int, device=None) -> list:
    """:func:`check_noninterference` through the plain step over
    ``(tag, axis)`` cells of :func:`model_matrix` x :data:`BUILD_AXES`,
    each at its model's certification horizon, on ``device``; returns
    the reports, each with its axis in ``flags["axis"]``."""
    models = {tag: (wl, cfg, horizon) for tag, wl, cfg, horizon in model_matrix()}
    cells = list(cells)
    unknown = [c for c in cells if c[0] not in models or c[1] not in BUILD_AXES]
    if not cells or unknown:
        # fail loudly on tag drift rather than shrink the matrix
        raise ValueError(f"check_matrix: cells {unknown or cells} are not (tag, axis) "
                         f"pairs of model_matrix() x BUILD_AXES")
    reports = []
    for tag, axis in cells:
        wl, cfg, horizon = models[tag]
        rep = check_noninterference(wl, cfg, seeds=seeds, n_steps=n_steps, horizon_ns=horizon,
                                    device=device, **BUILD_AXES[axis])
        rep.flags["axis"] = axis
        reports.append(rep)
    return reports
