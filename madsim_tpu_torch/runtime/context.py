"""Thread-local simulation context.

Parity with reference madsim/src/sim/runtime/context.rs: a thread-local
current ``Handle`` + current ``Task`` is how free functions (``spawn``,
``sleep``, ``thread_rng``, the interposed stdlib functions) find the
runtime they belong to (context.rs:9-77). One OS thread hosts at most one
simulation at a time; multi-seed test runs use one thread per seed
(reference sim/runtime/builder.rs:118-136), which this TLS design supports
unchanged.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import TYPE_CHECKING, Iterator

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from .runtime import Handle
    from .task import Task

__all__ = [
    "current_handle",
    "try_current_handle",
    "current_task",
    "try_current_task",
    "enter",
    "enter_task",
    "in_simulation",
]

_tls = threading.local()


class NoContextError(RuntimeError):
    pass


def try_current_handle() -> "Handle | None":
    return getattr(_tls, "handle", None)


def current_handle() -> "Handle":
    h = try_current_handle()
    if h is None:
        raise NoContextError(
            "there is no simulation context on this thread; "
            "this API must be called from within a madsim_tpu_torch Runtime"
        )
    return h


def try_current_task() -> "Task | None":
    return getattr(_tls, "task", None)


def current_task() -> "Task":
    t = try_current_task()
    if t is None:
        raise NoContextError("not inside a simulated task")
    return t


def in_simulation() -> bool:
    """True when the calling thread is inside a simulation context.

    The analog of the reference's "is this thread in a madsim context"
    check that gates every libc interposition (e.g. rand.rs:178-186).
    """
    return try_current_handle() is not None


@contextmanager
def enter(handle: "Handle") -> Iterator[None]:
    """Set the current runtime handle for this thread (context.rs:41-56)."""
    prev = getattr(_tls, "handle", None)
    _tls.handle = handle
    try:
        yield
    finally:
        _tls.handle = prev


@contextmanager
def enter_task(task: "Task") -> Iterator[None]:
    """Set the current task while the executor polls it (context.rs:58-77)."""
    prev = getattr(_tls, "task", None)
    _tls.task = task
    try:
        yield
    finally:
        _tls.task = prev
