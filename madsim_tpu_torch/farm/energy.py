"""AFLFast-style power schedules for the farm, at two levels.

Port of ``madsim_tpu/farm/energy.py`` (host code: integer weights and
numpy threefry draws, identical in both packages).

AFL's insight (refined by AFLFast, Boehme et al. CCS'16): not every
corpus entry deserves the same mutation budget. Entries exercising
rare paths and entries that have not been fuzzed much deserve MORE
energy; entries picked over and over deserve exponentially less — the
schedule moves budget from the well-mined center of the corpus to its
frontier. The farm applies the same economics twice:

* **across corpus entries** (:class:`EnergySchedule`, plugged into
  ``explore.run(energy=...)``): a parent's weight starts from its
  admission score (``new_bits``, the bits it set first), gains bonuses
  for violating and for touching rare coverage bits (bits set by at
  most ``rare_k`` entries), and decays polynomially with the number of
  times it has already been picked. Seed inheritance becomes
  per-parent (violating parents hold their engine seed more often —
  the fault alignment is the find).
* **across tenants** (:class:`FarmEnergy`, plugged into
  ``farm.run_farm(energy=...)``): each scheduler slice is awarded by
  weighted draw where a tenant's weight is its last slice's new
  coverage bits plus a violation bonus — budget drains away from
  plateaued tenants toward those still finding things.

Determinism is non-negotiable: every draw at both levels comes from
counter-based threefry under the registered ``farm`` purpose lane
(``engine.rng.PURPOSE_FARM`` — per-child parent picks at ``x1 =
base``, tenant awards at ``x1 = base + 1``), disjoint by the lane
registry from the explore mutation stream. Turning energy on changes
WHICH parents breed, never the draws a given (parent, child key)
mutation consumes; turning it off (``mode="uniform"``, or simply not
passing it) is bit-identical to the historical uniform schedule — the
reproducible default, test-pinned.

All weights are integer arithmetic (no float accumulation), so a
schedule replays exactly across platforms.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..engine.rng import PURPOSE_FARM, np_threefry2x32
from ..explore.mutate import HostStream, inherit_threshold

__all__ = ["EnergySchedule", "FarmEnergy"]


@dataclasses.dataclass(frozen=True)
class EnergySchedule:
    """Corpus-entry power schedule for ``explore.run(energy=...)``.

    ``mode="fast"`` (the AFLFast shape) is the only adaptive mode;
    ``mode="uniform"`` is inert — the driver runs its historical
    frontier-first ``select_top``/``inherit_seed_p`` pick,
    bit-identically (the non-interference certificate in
    tools/lint_soak.py pins this).

    The parent pool is the driver's OWN frontier (violating first,
    newest first — recency won the kvchaos equal-budget measurement,
    and diluting energy across the whole mined corpus measurably loses
    to it), ``top`` entries deep (None = the driver's ``select_top``).
    An entry's integer weight each generation:

        base = 1 + min(new_bits, bits_cap)
               + viol_bonus  (if the entry violates)
               + rare_bonus  (if it touches a bit set by <= rare_k
                              pool entries)
        weight = max(base * 64 // (1 + times_picked) ** decay, 1)

    ``bits_cap`` bounds the admission-score term: an outlier entry
    that lit up 30 new bits should not soak up the whole generation's
    energy (parent DIVERSITY is itself budget — concentrated picks
    breed duplicate traces the dedup then discards).

    ``inherit_seed_p`` / ``inherit_viol_p`` are the per-parent seed
    inheritance probabilities; None inherits the campaign's
    ``inherit_seed_p`` (violating parents floor at 0.9 — holding the
    engine seed through the mutation is how a fault alignment is
    tuned rather than re-rolled).
    """

    mode: str = "fast"
    viol_bonus: int = 8
    rare_bonus: int = 4
    rare_k: int = 2
    decay: int = 2
    bits_cap: int = 32
    top: int | None = None
    inherit_seed_p: float | None = None
    inherit_viol_p: float | None = None

    @property
    def active(self) -> bool:
        return self.mode != "uniform"

    def state(self) -> "_EnergyState":
        """Fresh per-campaign mutable state (times-picked counters)."""
        if self.mode not in ("uniform", "fast"):
            raise ValueError(
                f"unknown energy mode {self.mode!r} (uniform|fast)"
            )
        return _EnergyState(self)


class _EnergyState:
    """One campaign's energy bookkeeping: the times-picked counters and
    the per-generation weight table. Owned by the driver loop; never
    serialized (a resumed campaign restarts its pick counters — the
    corpus scores it weights from ARE checkpointed)."""

    def __init__(self, sched: EnergySchedule):
        self.sched = sched
        self.picks: dict = {}  # corpus id -> times picked as parent

    def pool(self, corpus, select_top: int = 32):
        """The generation's parent pool and cumulative weights.

        Recomputed once per generation (picks made within a generation
        take effect the next one — batch-order independence keeps the
        weight table one vectorized pass)."""
        sched = self.sched
        # the driver's frontier order, at the schedule's own depth
        pool = sorted(
            corpus, key=lambda e: (not e.violating, -e.id)
        )[: max(sched.top if sched.top is not None else select_top, 1)]
        covs = np.stack([np.asarray(e.cov, np.uint32) for e in pool])
        bits = np.unpackbits(covs.view(np.uint8), axis=1).astype(bool)
        counts = bits.sum(axis=0)
        rare_cols = (counts > 0) & (counts <= sched.rare_k)
        rare = (bits & rare_cols[None, :]).any(axis=1)
        weights = np.empty(len(pool), np.int64)
        for i, e in enumerate(pool):
            base = 1 + min(int(e.new_bits), sched.bits_cap)
            if e.violating:
                base += sched.viol_bonus
            if bool(rare[i]):
                base += sched.rare_bonus
            picked = self.picks.get(e.id, 0)
            weights[i] = max((base * 64) // (1 + picked) ** sched.decay, 1)
        return pool, np.cumsum(weights)

    def choose(self, k0: int, k1: int, pool, cum) -> int:
        """Weighted parent pick for one child slot — ONE threefry draw
        on the farm lane (the child's own key, ``x1 = PURPOSE_FARM``),
        leaving the explore-lane mutation stream untouched."""
        fs = HostStream(k0, k1, PURPOSE_FARM)
        r = fs.bits() % int(cum[-1])
        i = int(np.searchsorted(cum, r, side="right"))
        e = pool[i]
        self.picks[e.id] = self.picks.get(e.id, 0) + 1
        return e.id

    def inherit_threshold(self, entry, default_p: float) -> int:
        seed_p = (self.sched.inherit_seed_p
                  if self.sched.inherit_seed_p is not None else default_p)
        if entry.violating:
            p = (self.sched.inherit_viol_p
                 if self.sched.inherit_viol_p is not None
                 else max(seed_p, 0.9))
        else:
            p = seed_p
        return inherit_threshold(p)


@dataclasses.dataclass(frozen=True)
class FarmEnergy:
    """Tenant-level power schedule for ``farm.run_farm(energy=...)``.

    Each scheduler slice is awarded to a live tenant by one weighted
    threefry draw (``x1 = PURPOSE_FARM + 1``, x0 = the slice index —
    coordinate-addressed, so the award sequence is a pure function of
    ``root_seed`` and the gain history). A tenant's weight:

        floor + last-slice new coverage bits
              + viol_weight * last-slice new violations

    Tenants that have never run weigh ``bootstrap`` (optimism: every
    tenant gets sampled before the gains can judge it).
    ``mode="uniform"`` is round-robin — the reproducible default
    ``run_farm`` uses when no energy is passed.
    """

    mode: str = "adaptive"
    root_seed: int = 0
    viol_weight: int = 16
    floor: int = 1
    bootstrap: int = 32

    @property
    def active(self) -> bool:
        return self.mode != "uniform"

    def pick(self, slice_idx: int, names, gains: dict) -> str:
        """The tenant awarded slice ``slice_idx``. ``names`` are the
        live tenants in declaration order; ``gains`` maps a tenant to
        its last slice's ``(new_cov_bits, new_violations)``."""
        weights = []
        for n in names:
            g = gains.get(n)
            if g is None:
                w = max(int(self.bootstrap), 1)
            else:
                w = max(
                    int(self.floor)
                    + int(g[0]) + int(self.viol_weight) * int(g[1]),
                    1,
                )
            weights.append(w)
        total = sum(weights)
        root = int(self.root_seed)
        a, _ = np_threefry2x32(
            np.uint32(root & 0xFFFFFFFF),
            np.uint32((root >> 32) & 0xFFFFFFFF),
            np.uint32(slice_idx & 0xFFFFFFFF),
            np.uint32(PURPOSE_FARM + 1),
        )
        r = int(a) % total
        acc = 0
        for n, w in zip(names, weights):
            acc += w
            if r < acc:
                return n
        return names[-1]
