"""Deterministic single-threaded task executor with chaos semantics.

Parity with reference madsim/src/sim/task.rs:
  * discrete-event hot loop: drain the ready queue in *random* order, poll
    each task, advance virtual time by a random 50-100 ns per poll, then
    jump the clock to the next timer event (task.rs:142-216, the loop in
    SURVEY §3.2).
  * nodes (simulated machines) own tasks; ``kill`` cancels every task on
    the node so their cleanup runs, bumps the node epoch, and resets each
    registered simulator's per-node state (task.rs:255-276).
  * ``restart`` = kill + re-run the node's stored init coroutine
    (task.rs:279-291); ``pause``/``resume`` stash and release ready tasks
    (task.rs:294-314).
  * a panicking task on a ``restart_on_panic`` node is caught and the node
    restarts after a random 1-10 s delay (task.rs:187-206); a panic in an
    un-awaited task anywhere else fails the whole simulation, matching the
    reference where the unwind propagates through ``block_on``.

The reference also interposes ``sched_getaffinity``/``sysconf``/
``pthread_attr_init`` and *forbids thread creation* inside a simulation
(task.rs:659-725); our analog lives in
:mod:`madsim_tpu_torch.runtime.intercept` (thread-spawn guard + per-node
``available_parallelism``).
"""

from __future__ import annotations

import asyncio as _real_asyncio

from typing import Any, Callable, Coroutine, Optional

from . import aio, context
from .future import SimFuture
from .mpsc import RandomQueue
from .rand import GlobalRng
from .time_ import TimeRuntime

__all__ = [
    "Executor",
    "NodeInfo",
    "Task",
    "JoinHandle",
    "FallibleTask",
    "JoinError",
    "DeadlockError",
    "TimeLimitError",
    "spawn",
    "spawn_local",
]

MAIN_NODE_ID = 0


class JoinError(Exception):
    """Awaiting a killed/aborted/panicked task (task.rs:608-631).

    ``is_cancelled()``/``is_panic()`` mirror the reference's accessors:
    kill/abort produce a cancelled JoinError; a task that raised
    produces a panic one (with the original exception as __cause__)."""

    def __init__(self, msg: str, *, panic: bool = False):
        super().__init__(msg)
        self._panic = panic

    def is_panic(self) -> bool:
        return self._panic

    def is_cancelled(self) -> bool:
        return not self._panic


class DeadlockError(RuntimeError):
    """No runnable task and no pending timer (task.rs:164)."""


class TimeLimitError(RuntimeError):
    """Virtual time exceeded the configured limit (task.rs:165-171)."""


class NodeInfo:
    """Per-node bookkeeping. Killing a node retires this object and installs
    a fresh one under the same id — the epoch semantics of task.rs:255-276
    (stale tasks still point at the retired info and get dropped)."""

    __slots__ = (
        "id",
        "name",
        "ip",
        "cores",
        "init",
        "restart_on_panic",
        "killed",
        "paused",
        "paused_tasks",
        "tasks",
    )

    def __init__(
        self,
        node_id: int,
        name: str,
        init: Optional[Callable[[], Coroutine]] = None,
        restart_on_panic: bool = False,
        cores: int = 1,
        ip: Optional[str] = None,
    ):
        self.id = node_id
        self.name = name
        self.ip = ip
        self.cores = cores
        self.init = init
        self.restart_on_panic = restart_on_panic
        self.killed = False
        self.paused = False
        self.paused_tasks: list[Task] = []
        self.tasks: list[Task] = []

    def __repr__(self) -> str:
        return f"NodeInfo(id={self.id}, name={self.name!r})"


class Task:
    __slots__ = (
        "id",
        "coro",
        "node",
        "name",
        "_fut",
        "scheduled",
        "finished",
        "_close_pending",
        "_pending_throw",
        "_aio_shim",
        "_aio_bridge",
        "_aio_ctx",
    )

    def __init__(self, task_id: int, coro: Coroutine, node: NodeInfo, name: str):
        self.id = task_id
        self.coro = coro
        self.node = node
        self.name = name
        self._fut = SimFuture(name=f"join:{name}")
        self.scheduled = False
        self.finished = False
        self._close_pending = False
        # lazily-built asyncio.current_task() stand-in (runtime/aio.py)
        self._aio_shim = None
        # the asyncio.Future returned by a raw asyncio.create_task, if
        # this task was spawned that way — switches exception routing to
        # asyncio semantics (runtime/aio.py, _on_panic)
        self._aio_bridge = None
        # contextvars.Context every poll runs under, when the task was
        # created with asyncio.create_task(..., context=ctx)
        self._aio_ctx = None
        # exception injected at the task's next poll (the cancellation
        # mechanism behind compat asyncio.timeout(): the timer arms this
        # and reschedules the task, and the executor throws it into the
        # coroutine at its current await point)
        self._pending_throw: Optional[BaseException] = None

    def throw_soon(self, exc: BaseException) -> None:
        """Arrange for ``exc`` to be raised inside the coroutine at its
        current suspension point on the next poll. Caller must schedule
        the task."""
        self._pending_throw = exc

    def kill(self) -> None:
        """Cancel: close the coroutine (finally blocks run — the analog of
        dropping the future, task.rs:270-271) and fail the join future."""
        if self.finished:
            return
        self.finished = True
        try:
            self.coro.close()
        except (ValueError, RuntimeError):
            # A task killing itself (or its own node) mid-poll: the
            # coroutine is currently running and cannot be closed here.
            # The executor closes it at the task's next suspension point
            # so its finally-block cleanup still runs.
            self._close_pending = True
        self._fut.set_exception(JoinError(f"task {self.name!r} was killed"))

    def __repr__(self) -> str:
        return f"Task(id={self.id}, name={self.name!r}, node={self.node.id})"


class JoinHandle:
    """Handle to a spawned task (task.rs:569-609)."""

    __slots__ = ("_task",)

    def __init__(self, task: Task):
        self._task = task

    @property
    def _fut(self) -> SimFuture:
        return self._task._fut

    def __await__(self):
        return self._task._fut.__await__()

    def done(self) -> bool:
        return self._task.finished

    def abort(self) -> None:
        """Cancel the task (tokio-style abort; kill-drops-future semantics)."""
        self._task.kill()

    # tokio parity alias
    cancel = abort

    def cancel_on_drop(self) -> "FallibleTask":
        """Scope-bound task (the JoinHandle::cancel_on_drop analog,
        task.rs:581-607). Python has no deterministic drop, so the drop
        point is an ``async with`` scope exit::

            async with handle.cancel_on_drop() as h:
                ...            # task aborted here if still running
        """
        return FallibleTask(self)


class FallibleTask:
    """Async context manager aborting its task at scope exit if still
    running — the deterministic analog of the reference's drop-based
    cancellation (task.rs:581-616)."""

    __slots__ = ("_handle",)

    def __init__(self, handle: JoinHandle):
        self._handle = handle

    async def __aenter__(self) -> JoinHandle:
        return self._handle

    async def __aexit__(self, *_exc) -> None:
        if not self._handle.done():
            self._handle.abort()

    def __await__(self):
        return self._handle.__await__()


class Executor:
    """Single-threaded discrete-event executor (task.rs:33-216)."""

    def __init__(self, rng: GlobalRng, time: TimeRuntime):
        self.rng = rng
        self.time = time
        self.queue: RandomQueue[Task] = RandomQueue()
        self.nodes: dict[int, NodeInfo] = {}
        self.main_node = NodeInfo(MAIN_NODE_ID, "main")
        self.nodes[MAIN_NODE_ID] = self.main_node
        self._next_node_id = 1
        self._next_task_id = 1
        self.time_limit_ns: Optional[int] = None
        # list of Simulator instances, installed by Runtime; consulted on
        # node create/reset (runtime/mod.rs:68-79 sims registry).
        self.simulators: list = []
        self._pending_panic: Optional[BaseException] = None
        # raw-asyncio interposition (runtime/aio.py): installed in the
        # running-loop slot around every poll so unmodified asyncio code
        # runs on simulated time
        self.aio_loop = aio.SimEventLoop(self)

    # ---- spawning -------------------------------------------------------
    def spawn_on(self, node: NodeInfo, coro: Coroutine, name: str = "") -> JoinHandle:
        if node.killed:
            coro.close()
            raise RuntimeError(f"cannot spawn on killed node {node.id}")
        task = Task(self._next_task_id, coro, node, name or coro.__name__)
        self._next_task_id += 1
        node.tasks.append(task)
        self._schedule(task)
        return JoinHandle(task)

    def _schedule(self, task: Task) -> None:
        if not task.finished and not task.scheduled:
            task.scheduled = True
            self.queue.push(task)

    def _waker(self, task: Task) -> Callable[[], None]:
        return lambda: self._schedule(task)

    # ---- the hot loop ---------------------------------------------------
    def block_on(self, coro: Coroutine) -> Any:
        main = self.spawn_on(self.main_node, coro, "main")
        main_fut = main._fut
        while True:
            self.run_all_ready()
            if self._pending_panic is not None:
                exc, self._pending_panic = self._pending_panic, None
                raise exc
            if main_fut.done():
                self._report_unretrieved_aio()
                return main_fut.result()
            if not self.time.advance_to_next_event():
                raise DeadlockError(
                    "all tasks will block forever: no runnable task and no "
                    "pending timer event"
                )
            if self.time_limit_ns is not None and self.time.now_ns() > self.time_limit_ns:
                raise TimeLimitError(
                    f"time limit of {self.time_limit_ns / 1e9}s exceeded"
                )

    def run_all_ready(self) -> None:
        """Drain the ready queue in random order (task.rs:176-216)."""
        while True:
            task = self.queue.try_pop_random(self.rng)
            if task is None:
                return
            task.scheduled = False
            if task.finished:
                continue
            node = task.node
            if node.killed:
                task.kill()
                continue
            if node.paused:
                node.paused_tasks.append(task)
                continue
            self._poll(task)
            # Each poll costs a random 50-100 ns of virtual time
            # (task.rs:213-214).
            self.time.advance(self.rng.randrange(50, 100))

    def _poll(self, task: Task) -> None:
        try:
            with context.enter_task(task):
                prev_loop = aio.enter_poll(self.aio_loop, task)
                try:
                    if task._pending_throw is not None:
                        exc_in, task._pending_throw = task._pending_throw, None
                        if task._aio_ctx is not None:
                            yielded = task._aio_ctx.run(task.coro.throw, exc_in)
                        else:
                            yielded = task.coro.throw(exc_in)
                    elif task._aio_ctx is not None:
                        # asyncio.Task parity: every poll runs under the
                        # task's contextvars Context (create_task context=)
                        yielded = task._aio_ctx.run(task.coro.send, None)
                    else:
                        yielded = task.coro.send(None)
                finally:
                    aio.exit_poll(self.aio_loop, task, prev_loop)
        except StopIteration as stop:
            task.finished = True
            task._fut.set_result(stop.value)
        except BaseException as exc:  # noqa: BLE001 - panic path
            self._on_panic(task, exc)
        else:
            if task._close_pending:
                # The task was killed during its own poll (self-kill); now
                # that it is suspended, drop it so finally blocks run.
                task._close_pending = False
                try:
                    task.coro.close()
                except RuntimeError:
                    pass
                return
            if task.node.killed:
                task.kill()
            elif isinstance(yielded, SimFuture):
                yielded.add_waker(self._waker(task))
            elif yielded is None:
                # a bare `yield` — asyncio.sleep(0)'s __sleep0 / yield-now:
                # hand the scheduler one turn, resume on a later drain
                self._schedule(task)
            elif aio.is_asyncio_future(yielded):
                # raw asyncio await (stdlib Future/Queue/Event/...): the
                # executor side of the asyncio await protocol — resume the
                # task when the future resolves (runtime/aio.py)
                aio.bridge_asyncio_future(yielded, self._waker(task))
            else:
                task.finished = True
                err = TypeError(
                    f"task {task.name!r} awaited a non-simulation awaitable "
                    f"({type(yielded).__name__}); only madsim_tpu_torch futures "
                    f"and asyncio awaitables can be awaited inside the "
                    f"simulator"
                )
                self._pending_panic = err
                return

    def _report_unretrieved_aio(self) -> None:
        """End-of-sim debugging aid: a raw ``asyncio.create_task`` task
        that died with an exception nobody awaited would otherwise be
        perfectly silent (asyncio semantics store it in the future; the
        GC-time "never retrieved" hook is deliberately a no-op because
        GC timing is nondeterministic). The END of the simulation IS a
        deterministic point, so report each one on stderr here —
        iteration order (node id, task creation order) is seeded-stable."""
        import sys as _sys

        for node_id in sorted(self.nodes):
            for task in self.nodes[node_id].tasks:
                fut = task._aio_bridge
                if (
                    fut is not None
                    and fut.done()
                    and not fut.cancelled()
                    # flag FIRST: .exception() clears _log_traceback
                    and getattr(fut, "_log_traceback", False)
                    and fut.exception() is not None
                ):
                    print(
                        f"note: asyncio task {task.name!r} (node {node_id}) "
                        f"died with an unretrieved exception: "
                        f"{fut.exception()!r}",
                        file=_sys.stderr,
                    )

    def _on_panic(self, task: Task, exc: BaseException) -> None:
        task.finished = True
        node = task.node
        if isinstance(exc, _real_asyncio.CancelledError):
            # asyncio-style cancellation ends ONLY the cancelled task —
            # the analog of tokio JoinHandle::abort (task.rs:611), which
            # does not panic the runtime. (Uncaught real exceptions still
            # fail the whole simulation below.)
            je = JoinError(f"task {task.name!r} was cancelled")
            je.__cause__ = exc
            task._fut.set_exception(je)
            return
        if node.restart_on_panic and node.id != MAIN_NODE_ID:
            # Kill the node *immediately* (sibling tasks stop, simulator
            # per-node state resets), then restart after a random 1-10 s
            # delay (task.rs:187-206, runtime/mod.rs:319-325).
            delay_ns = self.rng.randrange(1_000_000_000, 10_000_000_000)
            node_id = node.id
            je = JoinError(f"task {task.name!r} panicked: {exc!r}", panic=True)
            je.__cause__ = exc
            task._fut.set_exception(je)
            self.kill_node(node_id)
            self.time.add_timer_at(
                self.time.now_ns() + delay_ns,
                lambda: self.restart_node(node_id),
            )
            return
        if task._aio_bridge is not None:
            # the task was created via RAW asyncio.create_task: asyncio
            # exception semantics — the exception is stored for the
            # awaiter (gather/await/return_exceptions all behave as in
            # real asyncio) instead of failing the whole simulation
            je = JoinError(f"task {task.name!r} raised", panic=True)
            je.__cause__ = exc
            task._fut.set_exception(je)
            return
        # A panic in any other task fails the whole simulation, exactly like
        # the reference where the unwind propagates through block_on. (To
        # handle expected errors, return them as values from the task.)
        # This is deliberately independent of whether anyone is awaiting the
        # JoinHandle — error routing must not depend on scheduling order.
        je = JoinError(f"task {task.name!r} panicked", panic=True)
        je.__cause__ = exc
        task._fut.set_exception(je)
        self._pending_panic = exc

    # ---- node lifecycle (task.rs:255-332) -------------------------------
    def create_node(
        self,
        name: Optional[str] = None,
        init: Optional[Callable[[], Coroutine]] = None,
        restart_on_panic: bool = False,
        cores: int = 1,
        ip: Optional[str] = None,
    ) -> NodeInfo:
        node_id = self._next_node_id
        self._next_node_id += 1
        info = NodeInfo(node_id, name or f"node-{node_id}", init, restart_on_panic, cores, ip)
        self.nodes[node_id] = info
        for sim in self.simulators:
            sim.create_node(node_id)
        return info

    def _retire(self, info: NodeInfo) -> NodeInfo:
        info.killed = True
        for t in list(info.tasks):
            t.kill()
        info.tasks.clear()
        info.paused_tasks.clear()
        fresh = NodeInfo(
            info.id, info.name, info.init, info.restart_on_panic, info.cores, info.ip
        )
        self.nodes[info.id] = fresh
        for sim in self.simulators:
            sim.reset_node(info.id)
        return fresh

    def kill_node(self, node_id: int) -> None:
        if node_id == MAIN_NODE_ID:
            raise ValueError("cannot kill the main node")
        self._retire(self.nodes[node_id])

    def restart_node(self, node_id: int) -> None:
        if node_id == MAIN_NODE_ID:
            raise ValueError("cannot restart the main node")
        fresh = self._retire(self.nodes[node_id])
        if fresh.init is not None:
            self.spawn_on(fresh, fresh.init(), name=f"init:{fresh.name}")

    def pause_node(self, node_id: int) -> None:
        if node_id == MAIN_NODE_ID:
            raise ValueError("cannot pause the main node")
        self.nodes[node_id].paused = True

    def resume_node(self, node_id: int) -> None:
        info = self.nodes[node_id]
        info.paused = False
        for t in info.paused_tasks:
            self._schedule(t)
        info.paused_tasks.clear()


# ---- free functions -----------------------------------------------------


def spawn(coro: Coroutine, name: str = "") -> JoinHandle:
    """Spawn a task on the current node (task.rs:480-488)."""
    handle = context.current_handle()
    cur = context.try_current_task()
    node = cur.node if cur is not None else handle.executor.main_node
    return handle.executor.spawn_on(node, coro, name)


def spawn_local(coro: Coroutine, name: str = "") -> JoinHandle:
    """Alias of :func:`spawn` — the whole simulation is single-threaded
    (task.rs:490-497)."""
    return spawn(coro, name)


def spawn_blocking(f: Callable[[], Any], name: str = "") -> JoinHandle:
    """Run a sync closure in a task (task.rs:498-511). The reference
    deprecates this in simulation — real blocking would stall virtual
    time — so like it, the closure simply runs inline on the task."""

    async def runner():
        return f()

    return spawn(runner(), name or "spawn_blocking")


def yield_now() -> "SimFuture":
    """Cooperative yield: reschedule after other ready tasks/timers at
    the current instant (the tokio ``task::yield_now`` re-exported by
    the sim, madsim-tokio/src/lib.rs:25-27). Implemented as a zero
    sleep — a timer at *now* fires without advancing the clock."""
    return context.current_handle().time.sleep(0.0)
