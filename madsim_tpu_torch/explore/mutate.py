"""Deterministic plan mutation over a declarative plan space.

Port of ``madsim_tpu/explore/mutate.py``, numpy and Python ints as
there: the draw order is the contract the device mutator
(explore/device.py) reproduces draw for draw.

The corpus loop (explore/driver.py) keeps *interesting* ``(seed,
LiteralPlan)`` entries and breeds new candidates from them. This module
owns the breeding: a :class:`PlanSpace` pairs a :class:`FaultPlan` with
its per-slot :class:`~madsim_tpu_torch.chaos.plan.SlotTemplate` metadata, and
:func:`mutate_plan` applies 1..max_ops structural perturbations to a
parent plan:

* **retime** — redraw an event's time inside its slot's template window
  (line up a kill with the commit it should interrupt);
* **retarget** — redraw the event's node args from the template's
  target set (hit the OTHER replica; cut a different edge);
* **drop** — disable a slot (ddmin's move, applied generatively);
* **add** — re-enable a disabled slot with freshly drawn time/args
  (partitions compile one slot pair per node-subset edge, most of them
  disabled, so "add" grows cuts edge by edge).

Every draw comes from a :class:`HostStream` — scalar threefry on the
child's key, which the driver derives from ``(root seed, generation,
batch slot)``. No global RNG anywhere: the whole campaign is a pure
function of the root seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..chaos.plan import FaultPlan, LiteralPlan
from ..engine.core import pack_slow_arg
from ..engine.rng import np_threefry2x32

__all__ = ["HostStream", "PlanSpace", "mutate_plan", "mutation_table"]

# Effective retarget modes, one per plan slot — the static resolution of
# _retarget's condition chain (arg_kind x target-count). MODE_RETIME is
# the fallback: args are fixed for the slot, so a retarget op perturbs
# the time instead. The device mutator (explore/device.py) branches on
# these the same way the host chain does; mutation_table() is the one
# place the resolution happens, so the two implementations cannot
# disagree about which slot takes which branch.
MODE_NODE, MODE_PAIR, MODE_SLOW, MODE_SKEW, MODE_RETIME = range(5)

# draws a retarget consumes per mode (node: 1 pick; pair: 2 picks;
# slow: 2 picks + mult; skew: pick + skew; fallback: retime's 2) — the
# device mutator advances its draw counter by exactly these amounts so
# its stream stays draw-for-draw aligned with HostStream's edit script
RETARGET_DRAWS = (1, 2, 3, 2, 2)


def inherit_threshold(inherit_seed_p: float) -> int:
    """The 32-bit draw threshold below which a child inherits its
    parent's engine seed. Parity-critical like RETARGET_DRAWS: both
    campaign drivers compare the same draw against this SAME integer,
    so the probability->threshold mapping must resolve in one place."""
    return int(inherit_seed_p * (1 << 32))


class HostStream:
    """Sequential scalar draws from one threefry key (host-side).

    Unlike the engine's coordinate-addressed draws, mutation is an
    inherently sequential host edit script, so a running draw index is
    the natural counter — determinism holds because the edit script
    itself is deterministic. ``x1`` namespaces the stream (the driver
    passes PURPOSE_EXPLORE, far above every in-simulation purpose).
    """

    def __init__(self, k0: int, k1: int, x1: int):
        self._k0 = np.uint32(k0)
        self._k1 = np.uint32(k1)
        self._x1 = np.uint32(x1)
        self._j = 0

    def bits(self) -> int:
        a, _ = np_threefry2x32(self._k0, self._k1, np.uint32(self._j), self._x1)
        self._j += 1
        return int(a)

    def uniform(self, lo: int, hi: int) -> int:
        """Uniform int in [lo, hi) — the engine's modulo reduction."""
        return int(lo) + self.bits() % max(int(hi) - int(lo), 1)

    def pick(self, options):
        return options[self.bits() % len(options)]


class PlanSpace:
    """A :class:`FaultPlan` viewed as a search space.

    The FaultPlan supplies generation 0 (uniform per-seed compilation —
    exactly what ``search_seeds(plan=...)`` sweeps) and, through its
    ``slot_templates()``, the legal perturbation ranges for every slot.
    All plans in the campaign share the FaultPlan's slot count, so one
    built run serves every generation.
    """

    def __init__(self, plan: FaultPlan):
        if not isinstance(plan, FaultPlan):
            raise TypeError(
                f"PlanSpace wraps a FaultPlan, got {type(plan).__name__}"
            )
        self.plan = plan
        self.templates = plan.slot_templates()
        if len(self.templates) != plan.slots:
            raise ValueError(
                f"plan {plan.name!r} exposes {len(self.templates)} slot "
                f"templates for {plan.slots} slots"
            )
        for i, t in enumerate(self.templates):
            # a pair/slow retarget draws "some OTHER target": with one
            # distinct value the host stream would pick from an empty
            # list (ZeroDivisionError) while the device mutator would
            # silently breed b == a — refuse the space up front so both
            # drivers fail identically and loudly
            if t.arg_kind in ("pair", "slow") and len(t.targets) >= 2 \
                    and len(set(t.targets)) < 2:
                raise ValueError(
                    f"plan {plan.name!r} slot {i} ({t.arg_kind}) needs "
                    f">= 2 distinct targets to retarget, got "
                    f"{tuple(t.targets)}"
                )

    @property
    def slots(self) -> int:
        return self.plan.slots

    def uses_dup(self) -> bool:
        return self.plan.uses_dup()

    def hash(self) -> str:
        return self.plan.hash()


def _effective_mode(tmpl) -> int:
    """Static resolution of _retarget's branch for one slot template."""
    kind = tmpl.arg_kind
    if kind == "node" and tmpl.targets:
        return MODE_NODE
    if kind == "pair" and len(tmpl.targets) >= 2:
        return MODE_PAIR
    if kind == "slow" and len(tmpl.targets) >= 2:
        return MODE_SLOW
    if kind == "skew" and tmpl.targets:
        return MODE_SKEW
    return MODE_RETIME


def mutation_table(space: PlanSpace) -> dict:
    """The space's SlotTemplate tuple as static per-slot numpy arrays —
    the device-resident form of the mutation surface.

    ``explore.device``'s vectorized mutator reads windows, target sets
    and retarget modes from these arrays while the host mutators above
    read the templates directly; both resolve the retarget branch
    through :func:`_effective_mode`, and the draw-parity test pins the
    two implementations draw-for-draw. Targets are padded to the widest
    slot (``tcnt`` holds the live count; padding is never selected
    because every pick reduces modulo the count).
    """
    tm = space.templates
    p = len(tm)
    width = max((len(t.targets) for t in tm), default=0) or 1
    tgt = np.zeros((p, width), np.int64)
    for i, t in enumerate(tm):
        if t.targets:
            tgt[i, : len(t.targets)] = np.asarray(t.targets, np.int64)
    mode = np.asarray([_effective_mode(t) for t in tm], np.int32)
    return {
        "t_lo": np.asarray([t.t_min_ns for t in tm], np.int64),
        # the host _retime floor: hi = max(t_max, t_min + 1)
        "t_hi": np.asarray(
            [max(t.t_max_ns, t.t_min_ns + 1) for t in tm], np.int64
        ),
        "mode": mode,
        "rt_draws": np.asarray([RETARGET_DRAWS[m] for m in mode], np.int32),
        "tgt": tgt,
        "tcnt": np.asarray([len(t.targets) for t in tm], np.int32),
        "mult_lo": np.asarray([t.mult_min for t in tm], np.int64),
        "mult_hi": np.asarray([t.mult_max for t in tm], np.int64),
        "skew_lo": np.asarray([t.skew_min_ns for t in tm], np.int64),
        "skew_hi": np.asarray([t.skew_max_ns for t in tm], np.int64),
    }


def _retime(events, i, tmpl, stream, horizon=None):
    lo, hi = tmpl.t_min_ns, max(tmpl.t_max_ns, tmpl.t_min_ns + 1)
    if horizon is not None and lo < horizon < hi:
        # keep the redraw inside the parent's causal window: an event
        # past the halt clock can never change the trajectory
        hi = horizon
    # fine/coarse mix (the AFL havoc idiom): half the retimes jitter
    # locally around the parent's value — a near-miss fault alignment
    # is TUNED, not re-rolled — and half redraw over the whole window
    if stream.bits() % 2 == 0:
        delta = max((hi - lo) // 8, 1)
        t = events[i].t + stream.uniform(-delta, delta + 1)
        t = min(max(t, lo), hi - 1)
    else:
        t = stream.uniform(lo, hi)
    events[i] = dataclasses.replace(events[i], t=t)


def _retarget(events, i, tmpl, stream, horizon=None):
    kind = tmpl.arg_kind
    if kind == "node" and tmpl.targets:
        events[i] = dataclasses.replace(events[i], a0=int(stream.pick(tmpl.targets)))
    elif kind == "pair" and len(tmpl.targets) >= 2:
        a = int(stream.pick(tmpl.targets))
        b = int(stream.pick([t for t in tmpl.targets if t != a]))
        events[i] = dataclasses.replace(events[i], a0=a, a1=b)
    elif kind == "slow" and len(tmpl.targets) >= 2:
        a = int(stream.pick(tmpl.targets))
        b = int(stream.pick([t for t in tmpl.targets if t != a]))
        mult = stream.uniform(tmpl.mult_min, tmpl.mult_max + 1)
        events[i] = dataclasses.replace(
            events[i], a0=a, a1=int(pack_slow_arg(b, mult))
        )
    elif kind == "skew" and tmpl.targets:
        a = int(stream.pick(tmpl.targets))
        skew = stream.uniform(tmpl.skew_min_ns, tmpl.skew_max_ns + 1)
        events[i] = dataclasses.replace(events[i], a0=a, a1=skew)
    else:  # args are fixed for this slot: perturb the time instead
        _retime(events, i, tmpl, stream, horizon)


def mutate_plan(
    parent: LiteralPlan,
    space: PlanSpace,
    stream: HostStream,
    max_ops: int = 3,
    name: str = "mut",
    horizon: int | None = None,
) -> LiteralPlan:
    """Breed one child plan from ``parent`` (same slot count as the
    space). Applies 1..max_ops draws-driven perturbations; always
    returns a NEW LiteralPlan (the parent is never modified).

    ``horizon`` is the parent run's halt clock (ns): slots whose events
    fired after it are causally dead — perturbing them replays the
    parent bit-for-bit, a wasted simulation — so ops target the live
    region when a horizon is known (AFL's input-trimming economy).
    """
    if parent.slots != space.slots:
        raise ValueError(
            f"parent has {parent.slots} slots, space has {space.slots}"
        )
    events = list(parent.events)
    enabled = list(parent._mask())
    templates = space.templates

    def live(idx):
        if horizon is None:
            return idx
        alive = [i for i in idx if events[i].t < horizon]
        return alive or idx

    n_ops = 1 + stream.bits() % max(max_ops, 1)
    for _ in range(n_ops):
        # op weights (out of 8): retime 4, retarget 2, drop 1, add 1 —
        # retiming dominates because it is the gentlest move (a
        # violating parent's structure survives), while the structural
        # ops keep the plan-shape space reachable
        op = stream.bits() % 8
        on_idx = [i for i, e in enumerate(enabled) if e]
        off_idx = [i for i, e in enumerate(enabled) if not e]
        if op == 0 and off_idx:  # add: enable a reserved slot afresh
            i = stream.pick(off_idx)
            enabled[i] = True
            _retime(events, i, templates[i], stream, horizon)
            _retarget(events, i, templates[i], stream, horizon)
        elif op == 1 and len(on_idx) > 1:  # drop (keep at least one)
            enabled[stream.pick(live(on_idx))] = False
        elif op in (2, 3) and on_idx:
            i = stream.pick(live(on_idx))
            _retarget(events, i, templates[i], stream, horizon)
        elif on_idx:
            i = stream.pick(live(on_idx))
            _retime(events, i, templates[i], stream, horizon)
        elif off_idx:  # degenerate all-disabled parent: force an add
            i = stream.pick(off_idx)
            enabled[i] = True
            _retime(events, i, templates[i], stream, horizon)
            _retarget(events, i, templates[i], stream, horizon)
    return LiteralPlan(
        events=tuple(events), enabled=tuple(enabled), name=name
    )
