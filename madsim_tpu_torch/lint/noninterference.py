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

The JAX package's three other axes become dynamic checks of the same
kind, each with its live control:

* :data:`CHECK_AXES` — :func:`check_noninterference` with a ``verdict``
  (``state -> (S,) bool``, by default ``check.device.screen_ok`` over
  ``default_screens()``): perturbing every derived column but the four
  history columns leaves the history and the verdict equal on every
  seed; perturbing the history columns must change some verdict.
* :data:`CAMPAIGN_AXES` — :func:`check_campaign`: (a) a generation's
  children (their seeds and plan rows, as the device campaign makes
  them) through the campaign's runner, unsharded and sharded over a
  ``parallel`` mesh, under the perturbation above; (b) each
  generation's final view perturbed in its non-guidance derived columns
  before the judge and the admission, the campaign's outcome equal to
  the clean campaign's. The controls: :func:`plant_met_leak` around the
  runner, and ``cov`` (the guidance) perturbed, which must change the
  outcome.
* :data:`FLIGHT_AXES` — :func:`check_campaign` again inside an
  ``obs.flight.FlightRecorder`` with its profiler on: the reports equal
  the recorder-off ones, and every counted generation on the card waits
  once (``explore.device.counted_syncs``).
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
    "CAMPAIGN_AXES",
    "CHECK_AXES",
    "FLIGHT_AXES",
    "HISTORY_COLUMNS",
    "NonInterferenceReport",
    "campaign_fields",
    "check_campaign",
    "check_matrix",
    "check_noninterference",
    "model_matrix",
    "perturb_derived",
    "plant_met_leak",
    "screens_verdict",
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

# the campaign axes, the JAX package's flags: the device campaign's taps
# (coverage guidance, fleet metrics, latency sketches; the causal columns
# with a ring), sharded over a mesh; the same under the flight recorder's
# profiler; and the device history screens appended to the run
CAMPAIGN_AXES = {
    "sharded-campaign": dict(cov_words=8, metrics=True, latency=LatencySpec(ops=8, phases=2)),
    "sharded-causal": dict(cov_words=8, causal=True, timeline_cap=8),
}
FLIGHT_AXES = {
    "flight-campaign": dict(cov_words=8, metrics=True, latency=LatencySpec(ops=8, phases=2),
                            flight=True),
}
CHECK_AXES = {
    "device-check": dict(cov_words=8, metrics=True, check=True),
}

# the history columns: what a device verdict reads
HISTORY_COLUMNS = ("hist_word", "hist_t", "hist_count", "hist_drop")
# what a campaign's admission reads by design: its guidance
GUIDANCE_COLUMNS = ("cov", "cov_hits")

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
    # with a verdict: the history columns and the verdict that differed
    # under the non-history perturbation, as ``diffs`` reports a field
    verdicts: dict = dataclasses.field(default_factory=dict)
    # a campaign's outcome parts (summary, corpus, violations, cov_map,
    # curve, viol_curve) that differed from the clean campaign's under
    # the view perturbation: part -> {"perturb_seed"}
    outcome: dict = dataclasses.field(default_factory=dict)
    # the live controls: name -> {"what", "live", ...}; a dead control
    # fails the check
    controls: dict = dataclasses.field(default_factory=dict)
    # the check's other parts (a sharded sub-check's report as a dict,
    # the campaign's shape, the flight recorder's findings)
    parts: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return (not self.diffs and not self.chunking and not self.ranges
                and not self.verdicts and not self.outcome
                and all(c["live"] for c in self.controls.values())
                and all(p.get("ok", True) for p in self.parts.values()
                        if isinstance(p, dict)))

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self), "derived": list(self.derived),
                "perturb_seeds": list(self.perturb_seeds), "ok": self.ok}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "NonInterferenceReport":
        kw = {f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d}
        kw["derived"] = tuple(kw["derived"])
        kw["perturb_seeds"] = tuple(kw["perturb_seeds"])
        return cls(**kw)

    def summary(self) -> str:
        on = ", ".join(f"{k}={v}" for k, v in sorted(self.flags.items()) if v)
        what = (f"{self.workload} [{self.entry}] flags={{{on}}} {self.n_seeds} seeds x "
                f"{self.n_steps} steps in {self.chunks} chunks, contracts at a "
                f"{self.horizon_ns / 1e9:g} s horizon")
        if self.ok:
            more = "".join(f"; {s}" for s in self._ok_notes())
            return (f"OK   {what}: {len(self.derived)} derived columns perturbed under "
                    f"seeds {list(self.perturb_seeds)}, the core columns and the trace "
                    f"equal on every seed" + (f", {self.uncertified} uncertified"
                                              if self.uncertified else "") + more)
        lines = [f"LEAK {what}:"]
        for field, d in self.diffs.items():
            lines.append(f"  core column {field!r} differs on {d['seeds']} seeds (first "
                         f"{d['first_seed']}) after chunk {d['chunk']} under perturbation "
                         f"seed {d['perturb_seed']}")
        if self.chunking:
            lines.append(f"  the chunked clean run differs from the unchunked one in "
                         f"{self.chunking}")
        for field, d in self.verdicts.items():
            lines.append(f"  {field!r} differs on {d['seeds']} seeds (first {d['first_seed']}) "
                         f"after chunk {d['chunk']} with the history columns left alone, "
                         f"perturbation seed {d['perturb_seed']}")
        for part, d in self.outcome.items():
            lines.append(f"  the campaign's {part} differs from the clean campaign's under "
                         f"perturbation seed {d['perturb_seed']}")
        for name, c in self.controls.items():
            if not c["live"]:
                lines.append(f"  the control {name!r} ({c['what']}) went unreported")
        for name, p in self.parts.items():
            if isinstance(p, dict) and not p.get("ok", True):
                lines.append(f"  {name}: " + (NonInterferenceReport.from_dict(p).summary()
                                              if "diffs" in p else json.dumps(p, sort_keys=True)))
        for r in self.ranges:
            lines.append(f"  {r['field']} outside [{r['lo']}, {r['hi']}] on {r['seeds']} "
                         f"seeds (first {r['first_seed']}; {r['min']}..{r['max']}) after "
                         f"chunk {r['chunk']} (perturbation seed {r['perturb_seed']})")
        return "\n".join(lines)


    def _ok_notes(self) -> list:
        """What a passing check held beyond the core columns."""
        notes = []
        if "verdict" in self.controls:
            notes.append("the history columns and the verdict equal with them left alone")
        if "campaign" in self.parts:
            c = self.parts["campaign"]
            notes.append(f"the campaign's outcome equal with {c['outcome_fields']} perturbed "
                         f"in every generation's view")
        if "sharded" in self.parts:
            notes.append(f"the same sharded over {self.parts['sharded']['flags'].get('mesh')} "
                         f"ranks")
        if "flight" in self.parts:
            f = self.parts["flight"]
            notes.append(f"the recorder added nothing ({f['records']} records, counted "
                         f"waits {f['host_syncs']})")
        notes += [f"control {n!r} reported" for n in self.controls]
        return notes


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


def _history_control(st: SimState, gen: torch.Generator) -> SimState:
    """``st`` with its history columns rewritten to full buffers of the
    words its own histories hold: every row used (``hist_count`` the
    capacity, ``hist_drop`` 0), each of a row's words drawn from the same
    word of a random recorded row, so that real ops, keys and arguments
    recombine as a screen's violations need (a uniform draw over a
    32-bit word almost never repeats an op or a key, and a non-zero
    ``hist_drop`` voids the verdict)."""
    word, count = st.hist_word, st.hist_count
    s, h, w = word.shape
    rows = word[torch.arange(h, device=word.device)[None, :] < count[:, None]]
    if rows.shape[0] == 0:
        return st
    pick = torch.randint(0, rows.shape[0], (s, h, w), generator=gen, device=word.device)
    mixed = torch.gather(rows, 0, pick.reshape(-1, w)).reshape(s, h, w)
    return dataclasses.replace(st, hist_word=mixed.contiguous(),
                               hist_count=torch.full_like(count, h),
                               hist_drop=torch.zeros_like(st.hist_drop))


def screens_verdict(screens):
    """The verdict of the device screens ``screens`` (``check.device``)
    over a state's history columns: ``state -> (S,) bool``, True where
    the seed passes every screen."""
    from ..check.device import as_screens, screen_ok

    screens = as_screens(screens)

    def verdict(st: SimState) -> torch.Tensor:
        return screen_ok(screens, st.hist_word, st.hist_t, st.hist_count, st.hist_drop)

    return verdict


def _first_diffs(masks: torch.Tensor, names, c: int, p: int, into: dict) -> None:
    """Record, for each name whose (S,) mask row has a True, the seeds,
    the first of them, the chunk and the perturbation seed (the first
    time only)."""
    counts = masks.sum(1).tolist()
    first = torch.argmax(masks.to(torch.int64), dim=1).tolist()
    for i, f in enumerate(names):
        if counts[i] and f not in into:
            into[f] = {"seeds": int(counts[i]), "first_seed": int(first[i]), "chunk": c,
                       "perturb_seed": int(p)}


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
    verdict=None,
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
    ``retry``, ``dup_rows``; ``plan_slots`` for ``make_init``).

    ``verdict`` (``state -> (S,) bool``), or ``check=True`` among the
    flags (the verdict of ``check.device.default_screens()``, the row of
    :data:`CHECK_AXES`), adds the check axis: each perturbation seed
    also runs with every derived column perturbed but
    :data:`HISTORY_COLUMNS`, and the history columns and the verdict at
    every chunk boundary must equal the clean run's (``verdicts``); the
    control perturbs the history columns alone and must change some
    seed's final verdict (``controls["verdict"]``). A step entry
    (``make_step``, ``make_step_plain``) has no final states to judge."""
    from ..engine.core import make_step, make_step_plain

    if n_steps % chunks:
        raise ValueError(f"n_steps={n_steps} does not split into {chunks} equal chunks")
    check = bool(flags.pop("check", False))
    if check or verdict is not None:
        if run in (make_step, make_step_plain):
            raise ValueError("check=True judges a RUN's final states with the device "
                             "screens; use a run entry (make_run, make_run_plain)")
        if verdict is None:
            from ..check.device import default_screens

            verdict = screens_verdict(default_screens())
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

    judged = verdict is not None
    seen = (*HISTORY_COLUMNS, "verdict") if judged else ()

    def judge(st) -> dict:
        out = {f: getattr(st, f) for f in HISTORY_COLUMNS}
        out["verdict"] = torch.as_tensor(verdict(st), device=dev).to(torch.bool)
        return out

    # the clean run, its core columns (and, with a verdict, the history
    # and the verdict) kept at every chunk boundary
    clean, clean_v, st = [], [], state0
    for c in range(chunks):
        st = chunk(st)
        clean.append({f: getattr(st, f) for f in core})
        if judged:
            clean_v.append(judge(st))
        held(st, c, None)
    whole = run(wl, cfg, n_steps, **run_flags)(state0)
    chunking = [f for f in STATE_FIELDS
                if bool(_differs(getattr(whole, f), getattr(st, f)).any())]
    del whole

    def perturbed_run(p, over, hold):
        """``over`` perturbed before every chunk under seed ``p``; yields
        each chunk boundary's state."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(p))
        st = state0
        for c in range(chunks):
            st = chunk(perturb_derived(st, over, contracts, gen))
            if hold:
                held(st, c, p)
            yield c, st

    diffs: dict = {}
    verdicts: dict = {}
    keep = tuple(f for f in fields if f not in HISTORY_COLUMNS)
    for p in perturb_seeds:
        for c, st in perturbed_run(p, fields, True):
            masks = torch.stack([_differs(getattr(st, f), clean[c][f]) for f in core])
            _first_diffs(masks, core, c, p, diffs)
        if not judged:
            continue
        for c, st in perturbed_run(p, keep, False):
            masks = torch.stack([_differs(getattr(st, f), clean[c][f]) for f in core])
            _first_diffs(masks, core, c, p, diffs)
            got = judge(st)
            masks = torch.stack([_differs(got[f], clean_v[c][f]) for f in seen])
            _first_diffs(masks, seen, c, p, verdicts)
    controls = {}
    if judged:
        # the control: the clean final state's history columns alone
        # perturbed must move some seed's verdict, or the verdict reads
        # nothing of them
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(perturb_seeds[0]))
        moved = int((judge(_history_control(st, gen))["verdict"]
                     != clean_v[-1]["verdict"]).sum())
        controls["verdict"] = {"what": "the history columns perturbed change a verdict",
                               "live": moved > 0, "seeds": moved,
                               "clean_failing": int((~clean_v[-1]["verdict"]).sum())}
    out_flags = _json_flags(flags)
    if check:
        out_flags["check"] = True
    return NonInterferenceReport(
        workload=wl.name, config_hash=cfg.hash(),
        entry=getattr(run, "__name__", type(run).__name__),
        flags=out_flags, derived=perturbed, n_seeds=s, n_steps=n_steps,
        chunks=chunks, perturb_seeds=tuple(int(p) for p in perturb_seeds), diffs=diffs,
        chunking=chunking, ranges=range_rows, uncertified=uncert,
        horizon_ns=int(contracts["now"].hi), verdicts=verdicts, controls=controls,
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


def campaign_fields(wl: Workload, view: dict, reads=()) -> tuple:
    """The derived columns of a campaign's final ``view`` that its judge
    and admission must not read: the non-empty columns of
    ``derived_fields(wl)`` less the guidance (:data:`GUIDANCE_COLUMNS`),
    less the history columns where the workload records histories (the
    history verdict's input, and the overflow quarantine's), less
    ``reads``: the columns a final-state invariant reads by design (an
    SLO invariant's ``lat_hist``)."""
    skip = set(GUIDANCE_COLUMNS) | set(reads)
    if wl.history is not None:
        skip |= set(HISTORY_COLUMNS)
    return tuple(f for f in derived_fields(wl) if f not in skip and view[f].numel())


def _perturb_view(view: dict, fields, contracts: dict, gen: torch.Generator) -> dict:
    """A copy of a final-state ``view`` with each of ``fields`` drawn
    within its contract from ``gen``, on the view's device."""
    out = dict(view)
    for f in fields:
        if view[f].numel():
            out[f] = _draw(contracts[f], view[f], gen).contiguous()
    return out


def _outcome(rep) -> dict:
    """A campaign report's outcome, part by part: the summary, the corpus
    and violation stores, the coverage map and both curves."""
    def entry(e):
        return (e.id, e.generation, e.parent, int(e.seed), e.plan.hash(), int(e.trace),
                [int(x) for x in np.asarray(e.cov, np.uint32)], int(e.new_bits),
                bool(e.violating), int(e.halt_t))

    return {
        "summary": (len(rep.corpus), rep.next_id, len(rep.violations), rep.coverage_bits,
                    rep.sims),
        "corpus": [entry(e) for e in rep.corpus],
        "violations": [entry(e) for e in rep.violations],
        "cov_map": [int(w) for w in np.asarray(rep.cov_map, np.uint32)],
        "curve": [int(x) for x in rep.curve],
        "viol_curve": [int(x) for x in rep.viol_curve],
    }


# the flags a device campaign takes; timeline_cap rides only the
# children's check (a campaign's sweep runs no ring)
_CAMPAIGN_FLAGS = ("cov_words", "cov_hitcount", "metrics", "latency", "causal")


def check_campaign(
    wl: Workload,
    cfg: EngineConfig,
    space,
    *,
    invariant=None,
    history_check=None,
    reads=(),
    generations: int = 2,
    batch: int = 64,
    root_seed: int = 0,
    max_steps: int = 400,
    run=None,
    mesh=None,
    perturb_seeds: tuple = (1, 2),
    horizon_ns: int | None = None,
    device=None,
    **flags,
) -> NonInterferenceReport:
    """Check a device campaign (``explore.run_device``) for
    non-interference: the rows of :data:`CAMPAIGN_AXES` and, with
    ``flight=True`` among the flags, of :data:`FLIGHT_AXES`.

    The clean campaign (``generations`` of ``batch`` children from
    ``root_seed``, judged by ``invariant`` and/or ``history_check``) runs
    unsharded, and its last generation (a bred one when there are two or
    more) gives the children. Two obligations, each on every seed:

    (a) the children's state (``make_init(plan_slots=...)`` with their
        seeds and plan rows, the flags' taps, ``timeline_cap`` too)
        through ``run`` (default ``engine.make_run``: the run kernel on
        the card, the plain step on the CPU) passes
        :func:`check_noninterference` in 4 chunks; with a ``mesh``
        (``parallel.make_mesh``) again through
        ``parallel.shard_over_seeds`` (``parts["sharded"]``);
    (b) the campaign run again under each perturbation seed, with
        :func:`campaign_fields` (``reads``: the columns ``invariant``
        reads by design) of every generation's final view drawn within
        their contracts before the judge and the admission (the
        ``sweep_hook`` of ``run_device``; on the ``mesh`` when given),
        has the clean campaign's outcome: summary, corpus, violations,
        coverage map and curves (``outcome``).

    The controls: :func:`plant_met_leak` around ``run`` (with the fleet
    counters on) must be reported in ``step``; ``cov``, the guidance,
    perturbed the same way must change the outcome.

    ``flight=True`` runs the whole check twice, the second time inside an
    ``obs.flight.FlightRecorder`` with its profiler on, handed to every
    campaign as its telemetry, under ``explore.device.counted_syncs``
    (each campaign's first generation): the two reports must be equal,
    and every counted generation (on the card) must wait once
    (``parts["flight"]``)."""
    flight = bool(flags.pop("flight", False))
    kw = dict(invariant=invariant, history_check=history_check, reads=tuple(reads),
              generations=generations, batch=batch, root_seed=root_seed,
              max_steps=max_steps, run=run, mesh=mesh, perturb_seeds=tuple(perturb_seeds),
              horizon_ns=horizon_ns, device=device, flags=flags)
    if not flight:
        return _check_campaign(wl, cfg, space, telemetry=None, **kw)
    from ..explore.device import counted_syncs
    from ..obs.flight import FlightRecorder

    off = _check_campaign(wl, cfg, space, telemetry=None, **kw)
    records: list = []
    with FlightRecorder(records.append, profile=True) as rec, \
            counted_syncs(generations=1):
        on = _check_campaign(wl, cfg, space, telemetry=rec, **kw)
    gens = [r["host_syncs"] for r in records if r.get("event") == "generation"]
    counted = [h for h in gens if h is not None]
    same = on.to_dict() == off.to_dict()
    on.entry = f"flight-{on.entry}"
    on.flags["flight"] = True
    on.parts["flight"] = {
        "ok": same and all(h == 1 for h in counted), "equal": same,
        "records": len(records), "generations": len(gens), "host_syncs": counted,
        "compiles": sum(1 for r in records if r.get("event") == "compile"),
    }
    return on


def _check_campaign(wl, cfg, space, *, invariant, history_check, reads, generations, batch,
                    root_seed, max_steps, run, mesh, perturb_seeds, horizon_ns, device,
                    telemetry, flags) -> NonInterferenceReport:
    from ..chaos.plan import FaultPlan
    from ..engine.core import PlanRows, make_run, resolve_device
    from ..explore.device import _ROW_KEYS, run_device
    from ..explore.mutate import PlanSpace
    from ..parallel import shard_over_seeds

    unknown = set(flags) - set(_CAMPAIGN_FLAGS) - {"timeline_cap"}
    if unknown:
        raise ValueError(f"check_campaign: unknown flags {sorted(unknown)}")
    if isinstance(space, FaultPlan):
        space = PlanSpace(space)
    run = make_run if run is None else run
    dev = mesh.device if mesh is not None else resolve_device(device)
    held = generations - 1
    cam = {k: v for k, v in flags.items() if k in _CAMPAIGN_FLAGS}
    retry = space.plan.retry_spec() if hasattr(space.plan, "retry_spec") else None
    contracts = column_contracts(wl, cfg, horizon_ns=horizon_ns)
    base = dict(invariant=invariant, history_check=history_check, generations=generations,
                batch=batch, root_seed=root_seed, max_steps=max_steps, device=dev,
                telemetry=telemetry, **cam)

    # the clean campaign, unsharded: its outcome, and the last
    # generation's children and the columns of its view
    box: dict = {}

    def record(g, kids, view):
        if g == held:
            box.update(seed=kids["seed"], rows={f: kids[f] for f in _ROW_KEYS}, view=view)
        return view

    clean = run_device(wl, cfg, space, sweep_hook=record, **base)
    ref = _outcome(clean)
    over = campaign_fields(wl, box.pop("view"), reads)

    def perturber(fields, p):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(p))
        return lambda _g, _kids, view: _perturb_view(view, fields, contracts, gen)

    # (b): each perturbation seed's campaign (on the mesh, when given)
    # against the clean one, part by part
    outcome: dict = {}
    for p in perturb_seeds:
        got = _outcome(run_device(wl, cfg, space, sweep_hook=perturber(over, p), mesh=mesh,
                                  **base))
        for part, v in got.items():
            if v != ref[part] and part not in outcome:
                outcome[part] = {"perturb_seed": int(p)}
    got = _outcome(run_device(wl, cfg, space, sweep_hook=perturber(GUIDANCE_COLUMNS,
                                                                      perturb_seeds[0]),
                              mesh=mesh, **base))
    moved = [part for part, v in got.items() if v != ref[part]]
    controls = {"guidance": {"what": "cov perturbed in every generation's view changes "
                                     "the outcome", "live": bool(moved), "parts": moved}}

    # (a): the children through the campaign's runner, then sharded
    run_flags = dict(flags, retry=retry, dup_rows=space.uses_dup())
    rows = PlanRows(**box["rows"])

    def children(**extra):
        kw = dict(run_flags, **extra)
        kw.pop("dup_rows")
        return make_init(wl, cfg, device=dev, plan_slots=space.slots, **kw)(box["seed"], rows)

    common = dict(n_steps=max_steps, chunks=4, perturb_seeds=perturb_seeds,
                  horizon_ns=horizon_ns)
    rep = check_noninterference(wl, cfg, run=run, seeds=children(), **common, **run_flags)
    parts: dict = {}
    if mesh is not None:
        def sharded(wl_, cfg_, n, **kw):
            return shard_over_seeds(run(wl_, cfg_, n, **kw), mesh)

        sharded.__name__ = f"shard_over_seeds({getattr(run, '__name__', 'run')})"
        rep_s = check_noninterference(wl, cfg, run=sharded, seeds=children(), **common,
                                      **run_flags)
        rep_s.flags["mesh"] = mesh.size
        parts["sharded"] = rep_s.to_dict()

    def leaky(wl_, cfg_, n, **kw):
        return plant_met_leak(run(wl_, cfg_, n, **kw))

    leak = check_noninterference(wl, cfg, run=leaky, seeds=children(metrics=True),
                                 ranges=False, **dict(common, perturb_seeds=perturb_seeds[:1]),
                                 **dict(run_flags, metrics=True))
    controls["met-leak"] = {"what": "plant_met_leak around the chunk runner",
                            "live": "step" in leak.diffs, "reported": sorted(leak.diffs)}
    parts["campaign"] = {
        "generations": generations, "batch": batch, "root_seed": int(root_seed),
        "held_generation": held, "children": int(box["seed"].shape[0]),
        "outcome_fields": list(over), "violations": len(clean.violations),
        "corpus": len(clean.corpus), "cov_bits": clean.coverage_bits,
        "curve": ref["curve"], "viol_curve": ref["viol_curve"],
        "corpus_ids": [e.id for e in clean.corpus],
        "mesh": mesh.size if mesh is not None else None,
    }
    rep.entry = "sharded-campaign" if mesh is not None else "campaign"
    rep.flags = _json_flags(flags)
    rep.outcome, rep.controls, rep.parts = outcome, controls, parts
    return rep


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
