"""Virtual time: timer heap + mock clock.

Parity with reference madsim/src/sim/time/:
  * ``TimeRuntime`` owns the clock and timer wheel (time/mod.rs:21-75);
    the base wall-clock time is randomized per seed to land in ~2022
    (time/mod.rs:26-37) so tests can't depend on real dates.
  * ``advance_to_next_event`` jumps the clock to the next timer deadline
    plus a 50 ns epsilon and fires all due timers (time/mod.rs:45-60).
  * ``TimeHandle`` is the user API: sleep/sleep_until/timeout/interval
    (time/mod.rs:78-149), ``Instant``/``SystemTime`` mocks
    (time/system_time.rs), and ``interval`` with tick semantics
    (time/interval.rs).

Internally time is an integer count of nanoseconds since simulation start —
exact arithmetic, no float drift, trivially mirrored by the batched JAX
engine (int64) and the C++ oracle.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Coroutine

from .future import SimFuture, select
from .rand import GlobalRng

__all__ = [
    "NANOS_PER_SEC",
    "TimeRuntime",
    "TimeHandle",
    "Instant",
    "SystemTime",
    "Elapsed",
    "Interval",
    "MissedTickBehavior",
    "sleep",
    "sleep_until",
    "timeout",
    "interval",
    "now",
    "now_ns",
]

NANOS_PER_SEC = 1_000_000_000
# Epsilon added when jumping the clock to the next timer (time/mod.rs:53).
_JUMP_EPSILON_NS = 50


def _to_ns(seconds: float | int) -> int:
    return round(seconds * NANOS_PER_SEC)


class Elapsed(Exception):
    """Deadline elapsed — the analog of tokio/madsim time::error::Elapsed."""


class Instant:
    """Monotonic instant: ns since simulation start (time/system_time.rs)."""

    __slots__ = ("ns",)

    def __init__(self, ns: int):
        self.ns = ns

    @staticmethod
    def now() -> "Instant":
        from . import context

        return Instant(context.current_handle().time.now_ns())

    def elapsed(self) -> float:
        from . import context

        return (context.current_handle().time.now_ns() - self.ns) / NANOS_PER_SEC

    def __sub__(self, other: "Instant") -> float:
        return (self.ns - other.ns) / NANOS_PER_SEC

    def __add__(self, seconds: float) -> "Instant":
        return Instant(self.ns + _to_ns(seconds))

    def __lt__(self, o: "Instant") -> bool:
        return self.ns < o.ns

    def __le__(self, o: "Instant") -> bool:
        return self.ns <= o.ns

    def __eq__(self, o: object) -> bool:
        return isinstance(o, Instant) and self.ns == o.ns

    def __hash__(self) -> int:
        return hash(self.ns)

    def __repr__(self) -> str:
        return f"Instant({self.ns}ns)"


class SystemTime:
    """Mock wall clock; base randomized per seed (time/mod.rs:26-37)."""

    __slots__ = ("unix_ns",)

    def __init__(self, unix_ns: int):
        self.unix_ns = unix_ns

    @staticmethod
    def now() -> "SystemTime":
        from . import context

        t = context.current_handle().time
        task = context.try_current_task()
        skew = t.skew_of(task.node.id) if task is not None else 0
        return SystemTime(t.base_unix_ns + t.now_ns() + skew)

    def timestamp(self) -> float:
        return self.unix_ns / NANOS_PER_SEC

    def __sub__(self, other: "SystemTime") -> float:
        return (self.unix_ns - other.unix_ns) / NANOS_PER_SEC

    def __repr__(self) -> str:
        return f"SystemTime({self.unix_ns}ns)"


class TimeRuntime:
    """The timer heap + virtual clock driven by the executor."""

    def __init__(self, rng: GlobalRng):
        # Randomized base wall time within calendar year 2022
        # (parity: time/mod.rs:26-37 randomizes the epoch per seed).
        self.base_unix_ns = (
            rng.randrange(1_640_995_200, 1_672_531_199) * NANOS_PER_SEC
            + rng.randrange(0, NANOS_PER_SEC)
        )
        self._now_ns = 0
        self._heap: list[tuple[int, int, Callable[[], None]]] = []
        self._seq = 0  # deterministic FIFO tiebreak for equal deadlines
        rng.now_ns = self.now_ns  # wire the determinism-log clock
        # chaos clock skew (madsim_tpu_torch.chaos, KIND_SKEW analog): per-node
        # wall-clock offsets observed by SystemTime.now() on that node's
        # tasks. The simulation clock itself (timers, sleeps) is shared —
        # skew is what the *application* reads, the classic drifted-NTP
        # fault; it never shifts scheduling, so determinism is untouched.
        self.node_skew: dict[int, int] = {}

    def now_ns(self) -> int:
        return self._now_ns

    def skew_of(self, node_id: int | None) -> int:
        if node_id is None:
            return 0
        return self.node_skew.get(node_id, 0)

    def advance(self, delta_ns: int) -> None:
        """Advance the clock without firing timers (per-poll cost,
        task.rs:213-214)."""
        self._now_ns += delta_ns

    def add_timer_at(self, deadline_ns: int, callback: Callable[[], None]) -> None:
        """Register a timer callback (time/mod.rs:138-149)."""
        self._seq += 1
        heapq.heappush(self._heap, (deadline_ns, self._seq, callback))

    def next_deadline(self) -> int | None:
        return self._heap[0][0] if self._heap else None

    def advance_to_next_event(self) -> bool:
        """Jump to the next timer (+50 ns epsilon) and fire all due timers.

        Returns False when no timers remain (deadlock condition for the
        executor). Parity: time/mod.rs:45-60.
        """
        if not self._heap:
            return False
        deadline = self._heap[0][0]
        if deadline > self._now_ns:
            self._now_ns = deadline + _JUMP_EPSILON_NS
        self.fire_due()
        return True

    def fire_due(self) -> None:
        while self._heap and self._heap[0][0] <= self._now_ns:
            _, _, cb = heapq.heappop(self._heap)
            cb()


class MissedTickBehavior:
    """Interval catch-up policy (reference time/interval.rs:62-110)."""

    BURST = "burst"
    DELAY = "delay"
    SKIP = "skip"


class Interval:
    """Periodic ticks (reference time/interval.rs:112-160)."""

    def __init__(self, handle: "TimeHandle", period: float, start_ns: int):
        if period <= 0:
            raise ValueError("interval period must be > 0")
        self._handle = handle
        self._period_ns = _to_ns(period)
        self._next_ns = start_ns
        self.missed_tick_behavior = MissedTickBehavior.BURST

    async def tick(self) -> Instant:
        now = self._handle.now_ns()
        if self._next_ns > now:
            await self._handle.sleep_until_ns(self._next_ns)
        fired = self._next_ns
        behavior = self.missed_tick_behavior
        if behavior == MissedTickBehavior.BURST:
            self._next_ns = fired + self._period_ns
        elif behavior == MissedTickBehavior.DELAY:
            self._next_ns = self._handle.now_ns() + self._period_ns
        else:  # SKIP: next multiple of period after now
            now2 = self._handle.now_ns()
            missed = max(0, (now2 - fired) // self._period_ns)
            self._next_ns = fired + (missed + 1) * self._period_ns
        return Instant(fired)


class TimeHandle:
    """User-facing time API bound to one runtime (time/mod.rs:78-149)."""

    def __init__(self, rt: TimeRuntime):
        self._rt = rt

    @property
    def base_unix_ns(self) -> int:
        return self._rt.base_unix_ns

    def now_ns(self) -> int:
        return self._rt.now_ns()

    def skew_of(self, node_id: int | None) -> int:
        return self._rt.skew_of(node_id)

    def set_skew(self, node_id: int, skew_ns: int) -> None:
        """Set the node's wall-clock skew (chaos KIND_SKEW analog):
        SystemTime.now() on that node reads true time + skew_ns."""
        self._rt.node_skew[node_id] = int(skew_ns)

    def now(self) -> Instant:
        return Instant(self._rt.now_ns())

    def system_time(self) -> SystemTime:
        return SystemTime(self._rt.base_unix_ns + self._rt.now_ns())

    def add_timer_at(self, deadline_ns: int, cb: Callable[[], None]) -> None:
        self._rt.add_timer_at(deadline_ns, cb)

    def add_timer(self, delay_s: float, cb: Callable[[], None]) -> None:
        self._rt.add_timer_at(self._rt.now_ns() + _to_ns(delay_s), cb)

    def sleep_until_ns(self, deadline_ns: int) -> SimFuture:
        fut = SimFuture(name="sleep")
        self._rt.add_timer_at(deadline_ns, fut.set_result)
        return fut

    def sleep(self, seconds: float) -> SimFuture:
        """Sleep future (time/mod.rs:110-114, sleep.rs:20-55)."""
        return self.sleep_until_ns(self._rt.now_ns() + _to_ns(seconds))

    def sleep_until(self, instant: Instant) -> SimFuture:
        return self.sleep_until_ns(instant.ns)

    async def timeout(self, seconds: float, awaitable) -> Any:
        """Await with a deadline; raises :class:`Elapsed` on expiry
        (time/mod.rs:124-136).

        Accepts a SimFuture or a coroutine. A timed-out coroutine is
        cancelled (its finally blocks run), matching the reference where
        the inner future is dropped.
        """
        from . import task as _task

        if isinstance(awaitable, Coroutine):
            inner = _task.spawn(awaitable, name="timeout-inner")
            inner_fut: SimFuture = inner._fut
            cancel = inner.abort
        elif isinstance(awaitable, SimFuture):
            inner_fut = awaitable
            cancel = lambda: None  # noqa: E731 - dropping a bare future has no owner to cancel
        else:
            raise TypeError(f"timeout() expects a coroutine or SimFuture, got {type(awaitable)!r}")
        timer = self.sleep(seconds)
        idx, _ = await select(inner_fut, timer)
        if idx == 0:
            return inner_fut.result()
        cancel()
        raise Elapsed(f"deadline of {seconds}s elapsed")

    def interval(self, period: float) -> Interval:
        """Ticks immediately, then every ``period`` (interval.rs:38-60)."""
        return Interval(self, period, self._rt.now_ns())

    def interval_at(self, start: Instant, period: float) -> Interval:
        return Interval(self, period, start.ns)


# ---- free functions bound to the current context ------------------------


def _handle() -> TimeHandle:
    from . import context

    return context.current_handle().time


def sleep(seconds: float) -> SimFuture:
    return _handle().sleep(seconds)


def sleep_until(instant: Instant) -> SimFuture:
    return _handle().sleep_until(instant)


def timeout(seconds: float, awaitable) -> Any:
    return _handle().timeout(seconds, awaitable)


def interval(period: float) -> Interval:
    return _handle().interval(period)


def now() -> Instant:
    return _handle().now()


def now_ns() -> int:
    return _handle().now_ns()
