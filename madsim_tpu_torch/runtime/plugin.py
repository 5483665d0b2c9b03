"""Pluggable simulator framework.

Parity with reference madsim/src/sim/plugin.rs: a ``Simulator`` is a
per-runtime singleton registered on the Handle and keyed by its type
(plugin.rs:18-54, runtime/mod.rs:68-79); it receives node-lifecycle
callbacks so it can allocate per-node state on ``create_node`` and wipe it
on ``reset_node`` (= node kill / power failure). ``simulator(cls)`` looks
up the instance for the current runtime; ``node()`` returns the current
node id (plugin.rs:45-57).
"""

from __future__ import annotations

from typing import Type, TypeVar

__all__ = ["Simulator", "simulator", "node"]


class Simulator:
    """Base class for device simulators (NetSim, FsSim, user plugins).

    Constructed once per runtime with the runtime's rng/time/config plus
    the supervisor handle (the reference passes the Handle into
    ``Simulator::new``, plugin.rs:20-24)."""

    def __init__(self, rng, time, config, handle):
        self.rng = rng
        self.time = time
        self.config = config
        self.handle = handle

    def create_node(self, node_id: int) -> None:  # noqa: B027 - optional hook
        pass

    def reset_node(self, node_id: int) -> None:  # noqa: B027 - optional hook
        pass


S = TypeVar("S", bound=Simulator)


def simulator(cls: Type[S]) -> S:
    """The current runtime's instance of simulator type ``cls``."""
    from . import context

    return context.current_handle().simulator(cls)


def node() -> int:
    """Current node id (plugin.rs:57)."""
    from . import context

    return context.current_task().node.id
