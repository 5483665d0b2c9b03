"""One-shot futures and combinators for the deterministic executor.

This is the waker substrate of the simulator: the analog of Rust's
``std::future::Future`` + waker protocol that the reference executor drives
(reference: madsim/src/sim/task.rs polls `async_task` runnables). Here a
coroutine awaits a :class:`SimFuture`; the executor receives the yielded
future and registers a waker callback that re-schedules the task when the
future resolves.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

__all__ = [
    "SimFuture",
    "select",
    "join_all",
    "Cancelled",
]


class Cancelled(Exception):
    """Raised when awaiting a future whose producer was cancelled/killed."""


class SimFuture:
    """A one-shot future usable with ``await`` inside the simulation.

    Not thread-safe by design: a whole simulation runs on one OS thread
    (reference: madsim/src/sim/task.rs:142-216 single-threaded executor).
    """

    __slots__ = ("_done", "_result", "_exc", "_wakers", "name")

    def __init__(self, name: str = ""):
        self._done = False
        self._result: Any = None
        self._exc: BaseException | None = None
        self._wakers: list[Callable[[], None]] = []
        self.name = name

    # -- producer side ----------------------------------------------------
    def set_result(self, value: Any = None) -> None:
        if self._done:
            return
        self._done = True
        self._result = value
        self._wake()

    def set_exception(self, exc: BaseException) -> None:
        if self._done:
            return
        self._done = True
        self._exc = exc
        self._wake()

    def _wake(self) -> None:
        wakers, self._wakers = self._wakers, []
        for w in wakers:
            w()

    # -- consumer side ----------------------------------------------------
    def done(self) -> bool:
        return self._done

    def result(self) -> Any:
        if not self._done:
            raise RuntimeError("future not ready")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self) -> BaseException | None:
        return self._exc

    def add_waker(self, waker: Callable[[], None]) -> None:
        """Register a completion callback. Fires immediately if already done."""
        if self._done:
            waker()
        else:
            self._wakers.append(waker)

    def __await__(self):
        # Loop guards against spurious wakeups (e.g. select losers).
        while not self._done:
            yield self
        if self._exc is not None:
            raise self._exc
        return self._result


def _as_future(f) -> SimFuture:
    """Accept a SimFuture or anything wrapping one (JoinHandle's _fut) —
    tokio's combinators take JoinHandles because JoinHandle: Future;
    the duck-typed unwrap is the analog (task.rs:569-609)."""
    return f if isinstance(f, SimFuture) else getattr(f, "_fut", f)


def select(*futures) -> SimFuture:
    """Future resolving to ``(index, input)`` of the first completed input.

    The deterministic analog of ``tokio::select!`` / ``futures::select``.
    Accepts SimFutures or spawn() JoinHandles; the winner is returned
    AS PASSED (a JoinHandle input resolves to that JoinHandle, so e.g.
    ``loser.abort()`` / identity checks against the inputs work).
    """
    out = SimFuture(name="select")

    def mk(i: int, orig) -> Callable[[], None]:
        def on_done() -> None:
            if not out._done:
                out.set_result((i, orig))

        return on_done

    for i, orig in enumerate(futures):
        _as_future(orig).add_waker(mk(i, orig))
    return out


def join_all(futures: Iterable) -> SimFuture:
    """Future resolving to the list of all results (analog of join_all).

    Accepts SimFutures or spawn() JoinHandles, like tokio's join_all
    over JoinHandles (JoinHandle: Future)."""
    futs = [_as_future(f) for f in futures]
    out = SimFuture(name="join_all")
    remaining = len(futs)
    if remaining == 0:
        out.set_result([])
        return out
    state = {"n": remaining}

    def mk(f: SimFuture) -> Callable[[], None]:
        def on_done() -> None:
            if out._done:
                return
            if f._exc is not None:
                out.set_exception(f._exc)
                return
            state["n"] -= 1
            if state["n"] == 0:
                out.set_result([x.result() for x in futs])

        return on_done

    for f in futs:
        f.add_waker(mk(f))
    return out
