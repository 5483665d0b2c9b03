"""Deterministic async synchronization primitives.

The reference reuses real tokio's ``sync`` module unchanged because those
primitives are already deterministic *given deterministic scheduling*
(madsim-tokio/src/lib.rs:39-52 — the key insight called out in SURVEY.md
§2 C21). Python has no tokio to borrow, so this module provides the same
API surface natively: oneshot / mpsc / watch / broadcast channels, Mutex,
RwLock, Semaphore, Notify, Barrier. All wakeups go through SimFutures
polled by the seeded executor, so lock handoff order is randomized per
seed and reproducible from it.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Generic, Optional, TypeVar

from .runtime.future import SimFuture

T = TypeVar("T")

__all__ = [
    "oneshot",
    "channel",
    "unbounded_channel",
    "watch",
    "broadcast",
    "Mutex",
    "RwLock",
    "Semaphore",
    "Notify",
    "Barrier",
    "ChannelClosed",
]


class ChannelClosed(Exception):
    """All senders (or the receiver) of a channel are gone."""


# ---- oneshot -------------------------------------------------------------


class OneshotSender(Generic[T]):
    __slots__ = ("_fut",)

    def __init__(self, fut: SimFuture):
        self._fut = fut

    def send(self, value: T) -> None:
        if self._fut.done():
            raise ChannelClosed("oneshot receiver already resolved")
        self._fut.set_result(("ok", value))

    def is_closed(self) -> bool:
        return self._fut.done()


class OneshotReceiver(Generic[T]):
    __slots__ = ("_fut",)

    def __init__(self, fut: SimFuture):
        self._fut = fut

    def __await__(self):
        return self.recv().__await__()

    async def recv(self) -> T:
        kind, value = await self._fut
        if kind == "closed":
            raise ChannelClosed("oneshot sender dropped")
        return value

    def close(self) -> None:
        if not self._fut.done():
            self._fut.set_result(("closed", None))


def oneshot() -> tuple[OneshotSender, OneshotReceiver]:
    fut = SimFuture(name="oneshot")
    return OneshotSender(fut), OneshotReceiver(fut)


# ---- mpsc ----------------------------------------------------------------


class _ChannelCore:
    __slots__ = ("capacity", "queue", "recv_waiters", "send_waiters", "closed")

    def __init__(self, capacity: Optional[int]):
        self.capacity = capacity
        self.queue: deque = deque()
        self.recv_waiters: deque[SimFuture] = deque()
        self.send_waiters: deque[SimFuture] = deque()
        self.closed = False

    def _wake_one(self, waiters: deque) -> bool:
        while waiters:
            w = waiters.popleft()
            if not w.done():
                w.set_result(None)
                return True
        return False

    def push(self, item: Any) -> None:
        # hand directly to a waiting receiver when possible
        while self.recv_waiters:
            w = self.recv_waiters.popleft()
            if not w.done():
                w.set_result(("ok", item))
                return
        self.queue.append(item)

    def close(self) -> None:
        self.closed = True
        while self.recv_waiters:
            w = self.recv_waiters.popleft()
            if not w.done():
                w.set_result(("closed", None))
        while self.send_waiters:
            w = self.send_waiters.popleft()
            if not w.done():
                w.set_result(None)


class Sender(Generic[T]):
    __slots__ = ("_core",)

    def __init__(self, core: _ChannelCore):
        self._core = core

    async def send(self, value: T) -> None:
        core = self._core
        if core.closed:
            raise ChannelClosed("channel closed")
        if core.capacity is not None:
            while len(core.queue) >= core.capacity and not core.closed:
                fut = SimFuture(name="chan.send")
                core.send_waiters.append(fut)
                await fut
            if core.closed:
                raise ChannelClosed("channel closed")
        core.push(value)

    def try_send(self, value: T) -> bool:
        core = self._core
        if core.closed:
            raise ChannelClosed("channel closed")
        if core.capacity is not None and len(core.queue) >= core.capacity:
            return False
        core.push(value)
        return True

    def close(self) -> None:
        self._core.close()


class Receiver(Generic[T]):
    __slots__ = ("_core",)

    def __init__(self, core: _ChannelCore):
        self._core = core

    async def recv(self) -> Optional[T]:
        """Next value, or None once the channel is closed and drained."""
        core = self._core
        if core.queue:
            item = core.queue.popleft()
            core._wake_one(core.send_waiters)
            return item
        if core.closed:
            return None
        fut = SimFuture(name="chan.recv")
        core.recv_waiters.append(fut)
        kind, value = await fut
        if kind == "closed":
            return None
        return value

    def try_recv(self) -> Optional[T]:
        core = self._core
        if core.queue:
            item = core.queue.popleft()
            core._wake_one(core.send_waiters)
            return item
        return None

    def close(self) -> None:
        self._core.close()

    def __aiter__(self):
        return self

    async def __anext__(self) -> T:
        v = await self.recv()
        if v is None:
            raise StopAsyncIteration
        return v


def channel(capacity: int) -> tuple[Sender, Receiver]:
    """Bounded mpsc channel (tokio::sync::mpsc::channel analog)."""
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    core = _ChannelCore(capacity)
    return Sender(core), Receiver(core)


def unbounded_channel() -> tuple[Sender, Receiver]:
    core = _ChannelCore(None)
    return Sender(core), Receiver(core)


# ---- watch ---------------------------------------------------------------


class WatchSender(Generic[T]):
    __slots__ = ("_state",)

    def __init__(self, state: dict):
        self._state = state

    def send(self, value: T) -> None:
        st = self._state
        st["value"] = value
        st["version"] += 1
        waiters, st["waiters"] = st["waiters"], []
        for w in waiters:
            if not w.done():
                w.set_result(None)


class WatchReceiver(Generic[T]):
    __slots__ = ("_state", "_seen")

    def __init__(self, state: dict):
        self._state = state
        self._seen = state["version"]

    def borrow(self) -> T:
        return self._state["value"]

    async def changed(self) -> None:
        if self._state["version"] > self._seen:
            self._seen = self._state["version"]
            return
        fut = SimFuture(name="watch")
        self._state["waiters"].append(fut)
        await fut
        self._seen = self._state["version"]

    def clone(self) -> "WatchReceiver[T]":
        return WatchReceiver(self._state)


def watch(initial: T) -> tuple[WatchSender, WatchReceiver]:
    state = {"value": initial, "version": 0, "waiters": []}
    return WatchSender(state), WatchReceiver(state)


# ---- broadcast -----------------------------------------------------------


class BroadcastSender(Generic[T]):
    __slots__ = ("_subs",)

    def __init__(self) -> None:
        self._subs: list[_ChannelCore] = []

    def subscribe(self) -> Receiver:
        core = _ChannelCore(None)
        self._subs.append(core)
        return Receiver(core)

    def send(self, value: T) -> int:
        n = 0
        for core in self._subs:
            if not core.closed:
                core.push(value)
                n += 1
        return n

    def close(self) -> None:
        for core in self._subs:
            core.close()


def broadcast() -> BroadcastSender:
    return BroadcastSender()


# ---- locks ---------------------------------------------------------------


class Mutex(Generic[T]):
    """Async mutex; ``async with`` yields the protected value."""

    def __init__(self, value: T = None):
        self._value = value
        self._locked = False
        self._waiters: deque[SimFuture] = deque()

    async def acquire(self) -> T:
        while self._locked:
            fut = SimFuture(name="mutex")
            self._waiters.append(fut)
            await fut
        self._locked = True
        return self._value

    def release(self) -> None:
        if not self._locked:
            raise RuntimeError("release of unlocked Mutex")
        self._locked = False
        while self._waiters:
            w = self._waiters.popleft()
            if not w.done():
                w.set_result(None)
                break

    def set(self, value: T) -> None:
        self._value = value

    async def __aenter__(self) -> T:
        return await self.acquire()

    async def __aexit__(self, *exc) -> None:
        self.release()


class RwLock(Generic[T]):
    """Write-preferring RwLock (tokio semantics): once a writer is waiting,
    new readers queue behind it, so steady read traffic cannot starve
    writers."""

    def __init__(self, value: T = None):
        self._value = value
        self._readers = 0
        self._writer = False
        self._pending_writers = 0
        self._waiters: deque[SimFuture] = deque()

    def _wake_all(self) -> None:
        while self._waiters:
            w = self._waiters.popleft()
            if not w.done():
                w.set_result(None)

    async def read(self) -> "_ReadGuard[T]":
        while self._writer or self._pending_writers > 0:
            fut = SimFuture(name="rwlock.r")
            self._waiters.append(fut)
            await fut
        self._readers += 1
        return _ReadGuard(self)

    async def write(self) -> "_WriteGuard[T]":
        self._pending_writers += 1
        try:
            while self._writer or self._readers > 0:
                fut = SimFuture(name="rwlock.w")
                self._waiters.append(fut)
                await fut
        finally:
            self._pending_writers -= 1
        self._writer = True
        return _WriteGuard(self)


class _ReadGuard(Generic[T]):
    def __init__(self, lock: RwLock):
        self._lock = lock

    @property
    def value(self) -> T:
        return self._lock._value

    async def __aenter__(self) -> T:
        return self._lock._value

    async def __aexit__(self, *exc) -> None:
        self.release()

    def release(self) -> None:
        self._lock._readers -= 1
        if self._lock._readers == 0:
            self._lock._wake_all()


class _WriteGuard(Generic[T]):
    def __init__(self, lock: RwLock):
        self._lock = lock

    @property
    def value(self) -> T:
        return self._lock._value

    @value.setter
    def value(self, v: T) -> None:
        self._lock._value = v

    async def __aenter__(self) -> "_WriteGuard[T]":
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()

    def release(self) -> None:
        self._lock._writer = False
        self._lock._wake_all()


class Semaphore:
    def __init__(self, permits: int):
        self._permits = permits
        self._waiters: deque[SimFuture] = deque()

    async def acquire(self, n: int = 1) -> None:
        while self._permits < n:
            fut = SimFuture(name="sem")
            self._waiters.append(fut)
            await fut
        self._permits -= n

    def release(self, n: int = 1) -> None:
        self._permits += n
        # Wake every waiter: waiters re-check their own permit demand, so a
        # single wakeup could strand a small waiter behind a large one.
        while self._waiters:
            w = self._waiters.popleft()
            if not w.done():
                w.set_result(None)

    def available_permits(self) -> int:
        return self._permits

    async def __aenter__(self) -> None:
        await self.acquire()

    async def __aexit__(self, *exc) -> None:
        self.release()


class Notify:
    def __init__(self) -> None:
        self._notified = False
        self._waiters: deque[SimFuture] = deque()

    async def notified(self) -> None:
        if self._notified:
            self._notified = False
            return
        fut = SimFuture(name="notify")
        self._waiters.append(fut)
        await fut

    def notify_one(self) -> None:
        while self._waiters:
            w = self._waiters.popleft()
            if not w.done():
                w.set_result(None)
                return
        self._notified = True

    def notify_waiters(self) -> None:
        while self._waiters:
            w = self._waiters.popleft()
            if not w.done():
                w.set_result(None)


class Barrier:
    def __init__(self, n: int):
        self._n = n
        self._count = 0
        self._waiters: list[SimFuture] = []

    async def wait(self) -> bool:
        """Returns True for the leader (last arriver)."""
        self._count += 1
        if self._count == self._n:
            self._count = 0
            waiters, self._waiters = self._waiters, []
            for w in waiters:
                if not w.done():
                    w.set_result(False)
            return True
        fut = SimFuture(name="barrier")
        self._waiters.append(fut)
        return await fut or False
