"""asyncio API surface with per-call sim/real dispatch.

The analog of madsim-tokio (reference madsim-tokio/src/lib.rs): code
written against asyncio runs unmodified inside the deterministic
simulator. The reference's cfg-switch picks the implementation at build
time; Python has no build-time cfg, so every entry point here checks
``context.in_simulation()`` at call time — inside a simulated task it
uses the deterministic runtime (virtual time, seeded scheduling), outside
it delegates to the real asyncio module.

Note: since the loop-level interposition landed
(:mod:`madsim_tpu_torch.runtime.aio`), even code importing the REAL asyncio
module works inside sims — the stdlib primitives run against a
sim-backed loop installed in the running-loop slot. This module remains
the explicit-import surface (stable API, per-call dual dispatch for
code that must run in both worlds).

Covered surface (the part madsim-tokio simulates: task/time/sync —
lib.rs:4-52; io/fs/signal are delegated):
  sleep, wait_for, timeout, create_task, ensure_future, gather, wait,
  current_task, CancelledError, TimeoutError, Queue, LifoQueue,
  PriorityQueue, Lock, Event, Condition, Semaphore, BoundedSemaphore,
  run, get_event_loop (minimal).

Like the reference's insight that tokio's sync primitives are "already
deterministic given deterministic scheduling" (SURVEY §2 C21), the sim
implementations here are thin maps onto madsim_tpu_torch.sync.
"""

from __future__ import annotations

import heapq
import sys
from typing import Any, Coroutine, Optional

from ..runtime import context


def _stdlib_asyncio():
    """The standard library's asyncio, even where a shim (this one, or
    another package's) stands under the name ``asyncio`` in
    ``sys.modules``: then asyncio's ``__init__`` runs once more, into a
    module of its own, over the submodules already loaded, so every name
    is the same object as the real module's."""
    import importlib.machinery
    import importlib.util

    import asyncio

    if asyncio.__name__ == "asyncio":
        return asyncio
    spec = importlib.machinery.PathFinder.find_spec("asyncio")
    mod = importlib.util.module_from_spec(spec)
    for name, sub in list(sys.modules.items()):
        if name.startswith("asyncio.") and name.count(".") == 1:
            setattr(mod, name.split(".", 1)[1], sub)
    spec.loader.exec_module(mod)
    return mod


_real = _stdlib_asyncio()
from ..runtime.future import SimFuture
from ..sync import Notify
from ..sync import Semaphore as _SimSemaphore

__all__ = [
    "CancelledError",
    "TimeoutError",
    "sleep",
    "wait_for",
    "timeout",
    "create_task",
    "ensure_future",
    "gather",
    "wait",
    "FIRST_COMPLETED",
    "ALL_COMPLETED",
    "run",
    "Queue",
    "LifoQueue",
    "PriorityQueue",
    "QueueEmpty",
    "QueueFull",
    "Lock",
    "Event",
    "Condition",
    "Semaphore",
    "BoundedSemaphore",
]

CancelledError = _real.CancelledError
TimeoutError = _real.TimeoutError
QueueEmpty = _real.QueueEmpty
QueueFull = _real.QueueFull
FIRST_COMPLETED = _real.FIRST_COMPLETED
ALL_COMPLETED = _real.ALL_COMPLETED
FIRST_EXCEPTION = _real.FIRST_EXCEPTION


def _sim() -> bool:
    return context.in_simulation()


# ---------------------------------------------------------------------------
# time
# ---------------------------------------------------------------------------


async def sleep(delay: float, result: Any = None) -> Any:
    if not _sim():
        return await _real.sleep(delay, result)
    from ..runtime.time_ import sleep as sim_sleep

    await sim_sleep(delay)
    return result


async def wait_for(aw, timeout: Optional[float]):
    if not _sim():
        return await _real.wait_for(aw, timeout)
    from ..runtime.time_ import Elapsed
    from ..runtime.time_ import timeout as sim_timeout

    if timeout is None:
        return await _ensure_sim_future(aw)
    try:
        return await sim_timeout(timeout, _ensure_sim_future(aw))
    except Elapsed:
        raise TimeoutError from None


class timeout:
    """``async with asyncio.timeout(5):`` — py3.11 API. In simulation a
    virtual-time timer injects TimeoutError into the task at whatever
    await point it is parked on when the deadline expires — the same
    cancel-the-body semantics as real asyncio, so liveness guards keep
    working on code that blocks forever."""

    def __init__(self, delay: Optional[float]):
        self._delay = delay
        self._real_cm = None
        self._armed = False

    async def __aenter__(self):
        if not _sim():
            self._real_cm = _real.timeout(self._delay)
            return await self._real_cm.__aenter__()
        if self._delay is not None:
            handle = context.current_handle()
            task = context.current_task()
            self._armed = True

            def fire() -> None:
                if self._armed and not task.finished:
                    self._armed = False
                    task.throw_soon(TimeoutError())
                    handle.executor._schedule(task)

            handle.time.add_timer(max(self._delay, 0.0), fire)
        return self

    async def __aexit__(self, et, ev, tb):
        if self._real_cm is not None:
            return await self._real_cm.__aexit__(et, ev, tb)
        self._armed = False
        return False


# ---------------------------------------------------------------------------
# tasks
# ---------------------------------------------------------------------------


class _TaskWrapper:
    """asyncio.Task-like facade over a sim JoinHandle."""

    def __init__(self, handle):
        self._handle = handle

    def __await__(self):
        return self._handle.__await__()

    def done(self) -> bool:
        return self._handle.done()

    def cancel(self) -> bool:
        self._handle.abort()
        return True

    def result(self):
        fut = self._handle._fut
        if not fut.done():
            raise _real.InvalidStateError("result is not set")
        return fut.result()

    def exception(self):
        return self._handle._fut.exception()


def create_task(coro: Coroutine, *, name: Optional[str] = None):
    if not _sim():
        return _real.get_event_loop().create_task(coro, name=name)
    from ..runtime.task import spawn

    return _TaskWrapper(spawn(coro, name=name or ""))


def ensure_future(aw):
    if not _sim():
        return _real.ensure_future(aw)
    if isinstance(aw, (_TaskWrapper, SimFuture)):
        return aw
    return create_task(aw)


async def gather(*aws, return_exceptions: bool = False):
    if not _sim():
        return await _real.gather(*aws, return_exceptions=return_exceptions)
    tasks = [ensure_future(a) for a in aws]
    results = []
    for t in tasks:
        try:
            results.append(await t)
        except BaseException as e:  # noqa: BLE001 - mirrors asyncio.gather
            if return_exceptions:
                results.append(e)
            else:
                raise
    return results


async def wait(aws, *, timeout: Optional[float] = None,
               return_when: str = ALL_COMPLETED):
    if not _sim():
        return await _real.wait(aws, timeout=timeout, return_when=return_when)
    from ..runtime.future import select
    from ..runtime.time_ import sleep as sim_sleep

    tasks = [ensure_future(a) for a in aws]
    deadline = None
    if timeout is not None:
        deadline = create_task(sleep(timeout))
    pending = list(tasks)
    done: list = []
    while pending:
        futs = [t._handle._fut if isinstance(t, _TaskWrapper) else t for t in pending]
        if deadline is not None:
            futs = futs + [deadline._handle._fut]
        idx, _ = await select(*futs)
        if deadline is not None and idx == len(pending):
            break
        t = pending.pop(idx)
        done.append(t)
        if return_when == FIRST_COMPLETED:
            break
        if return_when == FIRST_EXCEPTION and t.exception() is not None:
            break
    if deadline is not None:
        deadline.cancel()
    return set(done), set(pending)


def _ensure_sim_future(aw):
    if hasattr(aw, "__await__"):
        return aw
    raise TypeError(f"not awaitable: {aw!r}")


def run(main: Coroutine, *, debug: Optional[bool] = None):
    """Outside a sim: real asyncio.run. (Inside a sim you are already in
    a runtime; just await.) A top-level run() under MADSIM_TEST_* env
    vars goes through the seeded Builder, so existing asyncio programs
    gain deterministic replay with one import change."""
    if _sim():
        raise RuntimeError(
            "asyncio.run() called inside a simulation; await the coroutine"
        )
    import os

    if any(k.startswith("MADSIM_TEST_") for k in os.environ):
        from ..runtime.builder import Builder

        b = Builder.from_env()
        if callable(main):
            # factory form: each seed gets a fresh coroutine
            return b.run(main)
        if b.count > 1 or b.check_determinism:
            raise TypeError(
                "asyncio.run(coro) cannot replay one coroutine object for "
                "multiple seeds; pass the async function itself "
                "(asyncio.run(main_fn)) or use @madsim_tpu_torch.test"
            )
        return b.run(lambda: main)
    if callable(main):
        main = main()
    return _real.run(main, debug=debug)


def get_event_loop():
    if not _sim():
        return _real.get_event_loop()
    return _SimLoop()


class _SimLoop:
    """Minimal loop facade for code that calls loop.create_task etc."""

    def create_task(self, coro: Coroutine, *, name: Optional[str] = None):
        return create_task(coro, name=name)

    def time(self) -> float:
        from ..runtime.time_ import now_ns

        return now_ns() / 1e9

    def call_later(self, delay: float, callback, *args):
        from ..runtime import context as _ctx

        _ctx.current_handle().time.add_timer(delay, lambda: callback(*args))


# ---------------------------------------------------------------------------
# sync primitives — deterministic given deterministic scheduling (C21)
# ---------------------------------------------------------------------------


class Queue:
    """asyncio.Queue over sim futures (unbounded when maxsize<=0)."""

    _REAL = None  # set below per class; subclasses keep their own order

    def __init__(self, maxsize: int = 0):
        if not _sim():
            self.__class__ = type(self)._REAL  # construct the real one
            type(self).__init__(self, maxsize)
            return
        self._maxsize = maxsize
        self._items: list = []
        self._getters: list[SimFuture] = []
        self._putters: list[tuple[SimFuture, Any]] = []
        self._unfinished_tasks = 0
        self._join_waiters: list[SimFuture] = []

    # -- sim implementation --
    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items

    def full(self) -> bool:
        return self._maxsize > 0 and len(self._items) >= self._maxsize

    def _pop_item(self):
        return self._items.pop(0)

    def _push_item(self, item) -> None:
        self._items.append(item)

    async def put(self, item) -> None:
        while self.full():
            fut = SimFuture(name="queue.put")
            self._putters.append((fut, None))
            await fut
        self.put_nowait(item)

    def put_nowait(self, item) -> None:
        if self.full():
            raise QueueFull
        self._push_item(item)
        self._unfinished_tasks += 1
        while self._getters:
            g = self._getters.pop(0)
            if not g.done():
                g.set_result(None)
                break

    async def get(self):
        while self.empty():
            fut = SimFuture(name="queue.get")
            self._getters.append(fut)
            await fut
        return self.get_nowait()

    def get_nowait(self):
        if self.empty():
            raise QueueEmpty
        item = self._pop_item()
        while self._putters:
            p, _ = self._putters.pop(0)
            if not p.done():
                p.set_result(None)
                break
        return item

    async def join(self) -> None:
        """Block until every item ever put has been marked task_done.

        The real asyncio contract (unfinished-task count, not queue
        emptiness): the reference's tokio shim gets this for free by
        reusing real tokio sync types (madsim-tokio/src/lib.rs:39-52 —
        "tokio::sync is designed for single thread"); the sim Queue
        implements the same counter semantics directly.
        """
        while self._unfinished_tasks > 0:
            fut = SimFuture(name="queue.join")
            self._join_waiters.append(fut)
            await fut

    def task_done(self) -> None:
        if self._unfinished_tasks <= 0:
            raise ValueError("task_done() called too many times")
        self._unfinished_tasks -= 1
        if self._unfinished_tasks == 0:
            waiters, self._join_waiters = self._join_waiters, []
            for w in waiters:
                if not w.done():
                    w.set_result(None)


class LifoQueue(Queue):
    def _pop_item(self):
        return self._items.pop()


class PriorityQueue(Queue):
    def _push_item(self, item) -> None:
        heapq.heappush(self._items, item)

    def _pop_item(self):
        return heapq.heappop(self._items)


Queue._REAL = _real.Queue
LifoQueue._REAL = _real.LifoQueue
PriorityQueue._REAL = _real.PriorityQueue


class Lock:
    def __init__(self):
        if not _sim():
            self.__class__ = _real.Lock
            _real.Lock.__init__(self)
            return
        self._sem = _SimSemaphore(1)

    async def acquire(self) -> bool:
        await self._sem.acquire()
        return True

    def release(self) -> None:
        self._sem.release()

    def locked(self) -> bool:
        return self._sem._permits == 0

    async def __aenter__(self):
        await self.acquire()
        return None

    async def __aexit__(self, *exc):
        self.release()
        return False


class Event:
    def __init__(self):
        if not _sim():
            self.__class__ = _real.Event
            _real.Event.__init__(self)
            return
        self._set = False
        self._waiters: list[SimFuture] = []

    def is_set(self) -> bool:
        return self._set

    def set(self) -> None:
        self._set = True
        waiters, self._waiters = self._waiters, []
        for w in waiters:
            if not w.done():
                w.set_result(None)

    def clear(self) -> None:
        self._set = False

    async def wait(self) -> bool:
        while not self._set:
            fut = SimFuture(name="event.wait")
            self._waiters.append(fut)
            await fut
        return True


class Semaphore:
    def __init__(self, value: int = 1):
        if not _sim():
            self.__class__ = _real.Semaphore
            _real.Semaphore.__init__(self, value)
            return
        self._sem = _SimSemaphore(value)

    async def acquire(self) -> bool:
        await self._sem.acquire()
        return True

    def release(self) -> None:
        self._sem.release()

    def locked(self) -> bool:
        return self._sem._permits == 0

    async def __aenter__(self):
        await self.acquire()
        return None

    async def __aexit__(self, *exc):
        self.release()
        return False


class BoundedSemaphore(Semaphore):
    def __init__(self, value: int = 1):
        if not _sim():
            self.__class__ = _real.BoundedSemaphore
            _real.BoundedSemaphore.__init__(self, value)
            return
        super().__init__(value)
        self._bound = value

    def release(self) -> None:
        if self._sem._permits >= self._bound:
            raise ValueError("BoundedSemaphore released too many times")
        super().release()


class Condition:
    def __init__(self, lock: Optional[Lock] = None):
        if not _sim():
            self.__class__ = _real.Condition
            _real.Condition.__init__(self, lock)
            return
        self._lock = lock or Lock()
        # plain waiter list (not Notify): asyncio semantics say a notify
        # with no waiters is a no-op, never a stored permit
        self._waiters: list[SimFuture] = []

    async def __aenter__(self):
        await self._lock.acquire()
        return self

    async def __aexit__(self, *exc):
        self._lock.release()
        return False

    async def wait(self) -> bool:
        fut = SimFuture(name="condition.wait")
        self._waiters.append(fut)
        self._lock.release()
        await fut
        await self._lock.acquire()
        return True

    def notify(self, n: int = 1) -> None:
        woken = 0
        while self._waiters and woken < n:
            w = self._waiters.pop(0)
            if not w.done():
                w.set_result(None)
                woken += 1

    def notify_all(self) -> None:
        self.notify(len(self._waiters))


def __getattr__(name: str):
    """Anything not simulated falls through to the real asyncio module
    (the lib.rs:39-52 'not simulated: reuse real' list)."""
    return getattr(_real, name)
