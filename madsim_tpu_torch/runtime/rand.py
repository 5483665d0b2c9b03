"""Deterministic global RNG — every random decision in the simulator flows
through one seeded stream.

Parity with reference madsim/src/sim/rand.rs:
  * ``GlobalRng`` seeded from a u64 (rand.rs:30-61)
  * op-log + replay-check used by the determinism checker (rand.rs:64-110):
    in log mode every draw appends ``hash(value) ^ hash(now_ns)``; in check
    mode each draw is compared against the recorded log and the first
    divergence raises :class:`DeterminismError` naming the simulated time —
    the analog of rand.rs:77-85 "non-determinism detected".
  * free functions ``thread_rng()`` / ``random()`` resolve the RNG through
    the thread-local context (rand.rs:115-146).

The reference additionally interposes libc ``getrandom``/``getentropy``
(rand.rs:174-240) so *std* entropy is deterministic; our Python analog is
:mod:`madsim_tpu_torch.runtime.intercept`, which patches :mod:`random`,
``os.urandom``, ``uuid`` and :mod:`time` while a simulation is entered.
"""

from __future__ import annotations

import random as _pyrandom
from typing import Callable, MutableSequence, Sequence, TypeVar

T = TypeVar("T")

__all__ = ["GlobalRng", "DeterminismError", "thread_rng", "random"]

_MASK64 = (1 << 64) - 1


class DeterminismError(RuntimeError):
    """Raised by the determinism checker when two same-seed runs diverge."""


class GlobalRng:
    """Single seeded RNG shared by the whole simulation run."""

    def __init__(self, seed: int):
        self.seed = seed
        self._rng = _pyrandom.Random(seed)
        self._log: list[int] | None = None
        self._check: list[int] | None = None
        self._check_pos = 0
        # Wired by TimeRuntime after construction; draws made before that
        # observe time 0 (ordering is still deterministic).
        self.now_ns: Callable[[], int] = lambda: 0

    # ---- determinism log / check (rand.rs:64-110) -----------------------
    def enable_log(self) -> None:
        self._log = []

    def take_log(self) -> list[int]:
        log, self._log = self._log, None
        assert log is not None, "enable_log was not called"
        return log

    def enable_check(self, log: list[int]) -> None:
        self._check = log
        self._check_pos = 0

    def _observe(self, value: object) -> None:
        if self._log is None and self._check is None:
            return
        t = self.now_ns()
        try:
            vh = hash(value)
        except TypeError:
            # Unhashable draw (e.g. random.choice over lists): fall back to
            # repr, which is deterministic within a process.
            vh = hash(repr(value))
        entry = (vh ^ hash(t)) & _MASK64
        if self._log is not None:
            self._log.append(entry)
        if self._check is not None:
            i = self._check_pos
            self._check_pos += 1
            if i >= len(self._check) or self._check[i] != entry:
                raise DeterminismError(
                    f"non-determinism detected at {t / 1e9:.9f}s "
                    f"(draw #{i}): the same seed produced a different "
                    f"random-op stream on replay"
                )

    # ---- draws ----------------------------------------------------------
    def randrange(self, lo: int, hi: int) -> int:
        """Uniform int in [lo, hi) — the analog of Rust gen_range(lo..hi)."""
        v = self._rng.randrange(lo, hi)
        self._observe(v)
        return v

    def random_float(self) -> float:
        v = self._rng.random()
        self._observe(v)
        return v

    def random_bool(self, p: float) -> bool:
        if p <= 0.0:
            return False
        if p >= 1.0:
            return True
        v = self._rng.random() < p
        self._observe(v)
        return v

    def randbytes(self, n: int) -> bytes:
        v = self._rng.randbytes(n)
        self._observe(v)
        return v

    def getrandbits(self, n: int) -> int:
        v = self._rng.getrandbits(n)
        self._observe(v)
        return v

    def gauss(self, mu: float = 0.0, sigma: float = 1.0) -> float:
        v = self._rng.gauss(mu, sigma)
        self._observe(v)
        return v

    def choice(self, seq: Sequence[T]) -> T:
        i = self.randrange(0, len(seq))
        return seq[i]

    def shuffle(self, seq: MutableSequence[T]) -> None:
        # Fisher-Yates through our observed randrange so shuffles are logged.
        for i in range(len(seq) - 1, 0, -1):
            j = self.randrange(0, i + 1)
            seq[i], seq[j] = seq[j], seq[i]


def thread_rng() -> GlobalRng:
    """The current simulation's RNG (reference rand.rs:115-137)."""
    from . import context

    return context.current_handle().rng


def random() -> float:
    """Uniform float in [0, 1) from the simulation RNG (rand.rs:139-146)."""
    return thread_rng().random_float()
