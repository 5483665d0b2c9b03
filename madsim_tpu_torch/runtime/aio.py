"""Raw-asyncio interposition: unmodified ``import asyncio`` code runs
deterministically inside the simulator.

The reference achieves "user code unchanged" by swapping tokio for the
simulator at build time (``--cfg madsim``; madsim-tokio re-exports the
sim, madsim-tokio/src/lib.rs:4-52). Python has no build-time cfg swap,
and the compat shim (:mod:`madsim_tpu_torch.compat.asyncio`) still requires
changing an import. This module closes the remaining gap at the
*event-loop seam* instead: while the executor polls a simulated task,
asyncio's thread-local running-loop slot (``_set_running_loop`` — the
same slot ``asyncio.run`` uses) points at a :class:`SimEventLoop`
whose ``call_soon``/``call_later``/``call_at``/``create_future``/
``create_task`` are backed by the deterministic executor and the
virtual clock. The stdlib's OWN pure-Python machinery — ``sleep``,
``Future``, ``Queue``, ``Event``, ``Lock``, ``Semaphore``,
``Condition``, ``gather``, ``timeout``, ``wait_for``, ``wait``,
``shield`` — then runs unmodified on simulated time with seeded
scheduling. ``asyncio.current_task()`` works through the documented
``_enter_task`` registration hook with a :class:`_TaskShim` carrying
tokio-abort-style cancellation (``cancel`` delivers ``CancelledError``
at the task's await point; ``cancelling``/``uncancel`` implement the
3.11+ cancellation-count protocol that ``asyncio.timeout`` relies on).

Semantics notes (parity choices, not accidents):
* Exception routing follows the API the user chose. A task spawned
  through the runtime's own surface (``spawn``/compat) keeps madsim
  semantics: an uncaught exception fails the whole simulation (the
  reference's unwind-through-``block_on``, task.rs:187-206). A task
  created via RAW ``asyncio.create_task`` gets asyncio semantics: the
  exception is stored in the returned future for its awaiter —
  ``gather(return_exceptions=True)`` and awaited-task propagation work
  exactly as in real asyncio. ``CancelledError`` ends only the
  cancelled task in both worlds (tokio ``JoinHandle::abort`` parity).
* ``cancel()`` on a raw task REQUESTS cancellation (CancelledError at
  the task's await point); a task that legally suppresses it still
  completes with its result, as in real asyncio.
* ``call_soon`` callbacks run when the executor next drains timers,
  in deterministic FIFO order per timestamp — reproducible, though not
  interleaved identically to a real asyncio loop (which no seeded
  scheduler is).
* Out-of-simulation asyncio is untouched: the running-loop slot is set
  only around simulated-task polls, so the std backends' real loops
  (std/net.py) are unaffected.
"""

from __future__ import annotations

import asyncio as _aio
import contextvars
from typing import Any, Callable, Coroutine, Optional

from . import context

__all__ = ["SimEventLoop", "enter_poll", "exit_poll", "bridge_asyncio_future"]

_enter_task = getattr(_aio.tasks, "_enter_task", None)
_leave_task = getattr(_aio.tasks, "_leave_task", None)
_set_running_loop = _aio.events._set_running_loop


class _SimHandle:
    """asyncio.Handle stand-in for callbacks scheduled on the sim clock."""

    __slots__ = ("_cb", "_args", "_context", "_cancelled")

    def __init__(self, cb, args, ctx):
        self._cb = cb
        self._args = args
        self._context = ctx
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True

    def cancelled(self) -> bool:
        return self._cancelled

    def _run(self) -> None:
        if self._cancelled:
            return
        if self._context is not None:
            self._context.run(self._cb, *self._args)
        else:
            self._cb(*self._args)


class _SimTimerHandle(_SimHandle):
    __slots__ = ("_when",)

    def __init__(self, when, cb, args, ctx):
        super().__init__(cb, args, ctx)
        self._when = when

    def when(self) -> float:
        return self._when


class _TaskShim:
    """What ``asyncio.current_task()`` returns inside the sim.

    Carries exactly the surface the stdlib's task-facing helpers use:
    the 3.11+ cancellation-count protocol (``asyncio.timeout``'s
    ``cancelling``/``uncancel`` accounting), ``get_loop`` (used by
    ``Timeout._reschedule``), and name/done introspection.
    ``cancel`` is the asyncio cancel: ``CancelledError`` is thrown into
    the coroutine at its current await point (the executor's
    ``throw_soon`` seam, the same mechanism compat.asyncio.timeout
    uses).
    """

    __slots__ = ("_task", "_loop", "_cancel_requests")

    def __init__(self, task, loop):
        self._task = task
        self._loop = loop
        self._cancel_requests = 0

    def get_loop(self):
        return self._loop

    def get_name(self) -> str:
        return self._task.name

    def done(self) -> bool:
        return self._task.finished

    def cancelled(self) -> bool:
        return False

    def cancel(self, msg: Optional[str] = None) -> bool:
        if self._task.finished:
            return False
        self._cancel_requests += 1
        exc = _aio.CancelledError() if msg is None else _aio.CancelledError(msg)
        self._task.throw_soon(exc)
        self._loop._executor._schedule(self._task)
        return True

    def cancelling(self) -> int:
        return self._cancel_requests

    def uncancel(self) -> int:
        if self._cancel_requests > 0:
            self._cancel_requests -= 1
        return self._cancel_requests


class SimEventLoop:
    """The deterministic loop object behind ``asyncio.get_running_loop()``
    inside a simulation. Not a real event loop — it never runs a loop of
    its own; it only translates the loop surface the stdlib primitives
    use onto the executor (ready queue) and TimeRuntime (timer heap)."""

    def __init__(self, executor):
        self._executor = executor

    # -- introspection the stdlib consults --------------------------------
    def get_debug(self) -> bool:
        return False

    def is_running(self) -> bool:
        return True

    def is_closed(self) -> bool:
        return False

    def time(self) -> float:
        return self._executor.time.now_ns() / 1e9

    # -- callback scheduling ----------------------------------------------
    def call_soon(self, callback, *args, context=None):
        h = _SimHandle(callback, args, context)
        t = self._executor.time
        t.add_timer_at(t.now_ns(), h._run)
        return h

    def call_later(self, delay, callback, *args, context=None):
        return self.call_at(self.time() + delay, callback, *args, context=context)

    def call_at(self, when, callback, *args, context=None):
        h = _SimTimerHandle(when, callback, args, context)
        self._executor.time.add_timer_at(round(when * 1e9), h._run)
        return h

    # -- futures & tasks ---------------------------------------------------
    def create_future(self) -> _aio.Future:
        return _aio.Future(loop=self)

    class _BridgeFuture(_aio.Future):
        """The object ``asyncio.create_task`` returns in a sim: a Future
        bridged to the sim task, plus the name surface the stdlib's
        ``_set_task_name`` hook expects (it silently skips objects
        without ``set_name``, which would drop user task names)."""

        _sim_task = None

        def set_name(self, name) -> None:
            if self._sim_task is not None and name is not None:
                self._sim_task.name = str(name)

        def get_name(self) -> str:
            return self._sim_task.name if self._sim_task is not None else ""

        def cancel(self, msg: Optional[str] = None) -> bool:
            # asyncio.Task.cancel contract: REQUEST cancellation — the
            # CancelledError is delivered at the task's await point, and
            # a task that legally suppresses it still completes with its
            # result (the future settles from the task outcome, via
            # on_sim_done). Plain Future.cancel would settle NOW and
            # discard a suppressed-cancel result.
            if self.done():
                return False
            task = self._sim_task
            if task is None or task.finished:
                return super().cancel(msg)
            exc = (
                _aio.CancelledError()
                if msg is None
                else _aio.CancelledError(msg)
            )
            task.throw_soon(exc)
            self.get_loop()._executor._schedule(task)
            return True

        def _settle_cancelled(self) -> None:
            if not self.done():
                super(SimEventLoop._BridgeFuture, self).cancel()

    def create_task(self, coro: Coroutine, *, name=None, context=None):
        """Spawn on the current node; return an ``asyncio.Future`` bridged
        to the sim task's join future. ``fut.cancel()`` requests
        cancellation asyncio-style (CancelledError at the task's await
        point; a suppressed cancel still yields the task's result)."""
        ex = self._executor
        cur = context_try_current()
        node = cur.node if cur is not None else ex.main_node
        handle = ex.spawn_on(
            node, coro, name or getattr(coro, "__name__", "aio-task")
        )
        task = handle._task
        # asyncio.Task parity: every poll runs under the task's Context —
        # the supplied one, or (as asyncio.Task does) a COPY of the
        # current context, so a child's contextvar mutations never leak
        # into the parent or siblings (the executor's _poll honors
        # _aio_ctx)
        task._aio_ctx = (
            context if context is not None else contextvars.copy_context()
        )
        fut = SimEventLoop._BridgeFuture(loop=self)
        fut._sim_task = task
        task._aio_bridge = fut
        sim_fut = handle._fut

        def on_sim_done() -> None:
            if fut.done():
                return
            exc = sim_fut.exception()
            if exc is None:
                fut.set_result(sim_fut._result)
            else:
                cause = exc.__cause__
                if isinstance(exc, _aio.CancelledError) or isinstance(
                    cause, _aio.CancelledError
                ):
                    fut._settle_cancelled()
                else:
                    fut.set_exception(cause if cause is not None else exc)

        sim_fut.add_waker(on_sim_done)
        return fut

    # -- network (asyncio.open_connection / start_server) ------------------
    async def create_connection(self, protocol_factory, host=None, port=None,
                                *, ssl=None, **kwargs):
        """Backs raw ``asyncio.open_connection`` with the simulated TCP
        (net/aio_streams.py adapts TcpStream to the Transport contract;
        lazy import — runtime must not import net at module load)."""
        if ssl is not None:
            raise NotImplementedError("ssl is not simulated")
        from ..net import aio_streams

        return await aio_streams.create_connection(
            self, protocol_factory, host, port, **kwargs
        )

    async def create_server(self, protocol_factory, host=None, port=None,
                            *, ssl=None, **kwargs):
        """Backs raw ``asyncio.start_server`` with the simulated TCP."""
        if ssl is not None:
            raise NotImplementedError("ssl is not simulated")
        from ..net import aio_streams

        return await aio_streams.create_server(
            self, protocol_factory, host, port, **kwargs
        )

    async def create_datagram_endpoint(self, protocol_factory,
                                       local_addr=None, remote_addr=None,
                                       **kwargs):
        """Backs raw datagram protocols with the simulated UDP."""
        from ..net import aio_streams

        return await aio_streams.create_datagram_endpoint(
            self, protocol_factory, local_addr, remote_addr, **kwargs
        )

    async def getaddrinfo(self, host, port, *, family=0, type=0, proto=0,
                          flags=0):
        """Deterministic resolver (net/addr.py lookup_host — simulated
        node names resolve; no real DNS), in getaddrinfo result shape."""
        import socket as _socket

        from ..net.addr import lookup_host

        # host=None is the stdlib idiom for the wildcard address
        return [
            (_socket.AF_INET, type or _socket.SOCK_STREAM, proto, "", a)
            for a in await lookup_host(
                ("" if host is None else host, port if port else 0)
            )
        ]

    def run_in_executor(self, executor, func, *args):
        """Simulated ``run_in_executor``: real worker threads are
        forbidden inside a sim (the thread-spawn guard, intercept.py),
        so the callable runs synchronously at the current virtual
        instant — any ``time.sleep`` it performs advances the virtual
        clock via the interposed stdlib. This also powers
        ``asyncio.to_thread``. Only the default executor (None) is
        meaningful; a custom executor object is accepted and ignored
        (there is exactly one simulated "thread")."""
        fut = self.create_future()
        try:
            fut.set_result(func(*args))
        except BaseException as exc:  # noqa: BLE001 - mirror real executor
            fut.set_exception(exc)
        return fut

    # -- misc hooks stdlib code may touch ----------------------------------
    def call_exception_handler(self, ctx: dict) -> None:
        # called mostly from Future.__del__ ("exception was never
        # retrieved") at GC time. It must be a no-op: GC timing is
        # nondeterministic, and a real task exception already failed the
        # whole simulation loudly through the executor's panic path —
        # anything raised here would be swallowed as an unraisable.
        pass

    def default_exception_handler(self, ctx: dict) -> None:  # pragma: no cover
        self.call_exception_handler(ctx)


def context_try_current():
    return context.try_current_task()


def enter_poll(loop: SimEventLoop, task):
    """Executor hot-path hook, called before every coroutine poll:
    install the sim loop in asyncio's running-loop slot and register
    the task shim for ``asyncio.current_task()``. Returns the previous
    slot value for :func:`exit_poll` — save + restore rather than
    reset-to-None, because a simulation run synchronously from inside a
    REAL asyncio coroutine must not clobber the outer loop's slot.
    Plain functions (no context-manager allocation): this runs once per
    poll of every task in every sim."""
    shim = task._aio_shim
    if shim is None:
        shim = _TaskShim(task, loop)
        task._aio_shim = shim
    prev = _aio.events._get_running_loop()
    _set_running_loop(loop)
    if _enter_task is not None:
        _enter_task(loop, shim)
    return prev


def exit_poll(loop: SimEventLoop, task, prev) -> None:
    if _leave_task is not None:
        try:
            _leave_task(loop, task._aio_shim)
        except RuntimeError:  # pragma: no cover - mismatched nesting
            pass
    _set_running_loop(prev)


def deterministic_as_completed(fs, *, timeout: Optional[float] = None):
    """Replacement for ``asyncio.as_completed`` inside simulations.

    CPython's implementation dedups the inputs through ``set(fs)`` and
    spawns them while iterating that set — i.e. in MEMORY-ADDRESS
    order, which consumes scheduling RNG in a different order on every
    replay. The determinism checker (MADSIM_TEST_CHECK_DETERMINISM)
    caught this as a genuine op-stream divergence, so the interposition
    layer (runtime/intercept.py) swaps in this version during sims:
    identical semantics — dedup by identity, completion-ordered
    awaitables, TimeoutError after ``timeout`` — but tasks spawn in
    INPUT order.
    """
    loop = _aio.events.get_running_loop()
    seen: set = set()
    todo: list = []
    for f in fs:
        # identity-dedup replicates set(fs) EQUALITY semantics; the
        # address value never orders anything (spawn stays input-order)
        if id(f) in seen:  # lint: allow(id-hash-branch)
            continue
        seen.add(id(f))
        todo.append(_aio.ensure_future(f, loop=loop))
    done: _aio.Queue = _aio.Queue()
    timeout_handle = None

    def _on_timeout():
        for f in todo:
            f.remove_done_callback(_on_completion)
            done.put_nowait(None)  # wake every waiter with TimeoutError
        todo.clear()

    def _on_completion(f):
        if not todo:
            return  # timeout already fired
        todo.remove(f)
        done.put_nowait(f)
        if timeout_handle is not None and not todo:
            timeout_handle.cancel()

    async def _wait_for_one():
        f = await done.get()
        if f is None:
            raise TimeoutError
        return f.result()

    for f in todo:
        f.add_done_callback(_on_completion)
    if todo and timeout is not None:
        timeout_handle = loop.call_later(timeout, _on_timeout)
    for _ in range(len(todo)):
        yield _wait_for_one()


def is_asyncio_future(obj: Any) -> bool:
    """The ``isfuture`` protocol check (asyncio.futures.isfuture):
    anything with ``_asyncio_future_blocking`` is awaited the asyncio
    way — yield the future itself, resume when done."""
    return getattr(obj, "_asyncio_future_blocking", None) is not None


def bridge_asyncio_future(fut: Any, waker: Callable[[], None]) -> None:
    """Register ``waker`` to run when the yielded asyncio future
    resolves — the executor-side half of the await protocol (what a
    real asyncio.Task.__step does with a yielded future)."""
    fut._asyncio_future_blocking = False
    fut.add_done_callback(lambda _f: waker())
