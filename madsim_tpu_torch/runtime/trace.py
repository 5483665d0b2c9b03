"""Tracing: structured, simulation-aware logging.

Parity with the reference's tracing integration (SURVEY.md §5): the
reference threads ``tracing`` spans through everything — a per-node span
(task.rs:119,266,327), a per-task span entered on every poll
(runtime/context.rs:58-69), ``#[instrument]`` on network ops, and a
subscriber initialized once by the test macro (runtime/mod.rs:385-389).

Here the same context comes from a logging.Filter that stamps every
record emitted inside a simulation with the *virtual* time, the current
node and task, and the seed — so interleaved multi-node logs read like
the reference's span-annotated output and, because time is simulated,
two same-seed runs produce byte-identical logs (useful with the
determinism checker).

    import madsim_tpu_torch as ms
    ms.init_logger()                # or MADSIM_LOG=debug via @ms.test
    log = logging.getLogger("myapp")
    log.info("leader elected")      # -> [12.304986s node=2(srv) task=elect seed=7] leader elected

``span(name)`` pushes a nested context segment (the #[instrument]
analog) onto the current task's span stack.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
from typing import Iterator, Optional

from . import context

__all__ = ["init_logger", "span", "SimContextFilter", "SimFormatter"]

# span stacks are per (handle, task) — stored on the TaskInfo via a
# plain attribute dict keyed by task id to avoid touching __slots__
_SPANS: dict[int, list[str]] = {}


class SimContextFilter(logging.Filter):
    """Stamp records with simulated time / node / task / seed."""

    def filter(self, record: logging.LogRecord) -> bool:
        handle = context.try_current_handle()
        if handle is None:
            record.sim = ""
            return True
        parts = [f"{handle.time.now_ns() / 1e9:.9f}s"]
        task = context.try_current_task()
        if task is not None:
            node = task.node
            name = f"({node.name})" if node.name else ""
            parts.append(f"node={node.id}{name}")
            parts.append(f"task={task.name}")
            spans = _SPANS.get(task.id)
            if spans:
                parts.append(":".join(spans))
        parts.append(f"seed={handle.seed}")
        record.sim = "[" + " ".join(parts) + "] "
        return True


class SimFormatter(logging.Formatter):
    def __init__(self) -> None:
        super().__init__("%(levelname).1s %(sim)s%(name)s: %(message)s")


_installed: Optional[logging.Handler] = None


def init_logger(level: "str | int | None" = None) -> None:
    """Install the simulation-aware log handler once (the analog of the
    test macro's subscriber init, runtime/mod.rs:385-389).

    Level comes from the argument or ``MADSIM_LOG`` (error/warn/info/
    debug/trace, default warn — mirroring RUST_LOG-style env control).
    """
    global _installed
    if _installed is not None:
        return
    if level is None:
        level = os.environ.get("MADSIM_LOG", "warning")
    if isinstance(level, str):
        level = {
            "error": logging.ERROR,
            "warn": logging.WARNING,
            "warning": logging.WARNING,
            "info": logging.INFO,
            "debug": logging.DEBUG,
            "trace": logging.DEBUG,
        }.get(level.lower(), logging.WARNING)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(SimFormatter())
    handler.addFilter(SimContextFilter())
    root = logging.getLogger()
    root.addHandler(handler)
    if root.level > level or root.level == logging.NOTSET:
        root.setLevel(level)
    _installed = handler


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Push a named span segment for the current task (#[instrument]
    analog): log records inside the block carry task=...:name."""
    task = context.try_current_task()
    if task is None:
        yield
        return
    stack = _SPANS.setdefault(task.id, [])
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()
        if not stack:
            _SPANS.pop(task.id, None)
