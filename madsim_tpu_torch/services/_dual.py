"""Dual-mode primitives: one service codebase, sim and real execution.

Every reference ecosystem crate is a drop-in that works in *both*
builds — `#[cfg(madsim)]` swaps the implementation at compile time
(madsim-etcd-client/src/lib.rs:1-8; madsim-rdkafka vendors the whole
real-rdkafka surface for the std build). Python has no cfg flags, so
the switch is a runtime check: when a deterministic simulation context
is active these helpers bind the sim network/time/rng, otherwise plain
asyncio and the std TCP endpoint. Service code (etcd, gRPC, kafka) uses
only this seam, making each simulator a true drop-in: the same client
and server classes run over localhost TCP unchanged.
"""

from __future__ import annotations

import random as _random_mod
from collections import deque
from typing import Any, Coroutine

from ..compat.asyncio import _real as _real_asyncio
from ..runtime import context

__all__ = [
    "bind_endpoint",
    "in_sim",
    "make_notify",
    "now_ns",
    "rng",
    "sleep",
    "spawn",
]


def in_sim() -> bool:
    return context.in_simulation()


def spawn(coro: Coroutine, name: str = ""):
    """Sim: deterministic task on the current node; std: asyncio task.
    Both returned handles support ``cancel()`` and ``await``."""
    from ..compat.asyncio import create_task

    return create_task(coro, name=name or None)


async def sleep(delay: float) -> None:
    from ..compat.asyncio import sleep as dual_sleep

    await dual_sleep(delay)


def now_ns() -> int:
    """Sim: virtual clock; std: the real clock."""
    if in_sim():
        from ..runtime.time_ import now_ns as sim_now_ns

        return sim_now_ns()
    import time as _time

    # the real-mode branch of the dual seam: outside a simulation the
    # real clock IS the contract
    return _time.time_ns()  # lint: allow(wall-clock)


class _StdRng(_random_mod.Random):
    def random_bool(self, p: float) -> bool:
        return self.random() < p


_std_rng = _StdRng()


def rng():
    """Sim: the seeded GlobalRng view (deterministic); std: a process
    RNG with the same surface."""
    if in_sim():
        from ..runtime.rand import thread_rng

        return thread_rng()
    return _std_rng


class _StdNotify:
    """asyncio mirror of :class:`madsim_tpu_torch.sync.Notify`."""

    def __init__(self) -> None:
        self._notified = False
        self._waiters: deque = deque()

    async def notified(self) -> None:
        if self._notified:
            self._notified = False
            return
        fut = _real_asyncio.get_event_loop().create_future()
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


def make_notify():
    if in_sim():
        from ..sync import Notify

        return Notify()
    return _StdNotify()


async def bind_endpoint(addr) -> Any:
    """The transport seam: the simulated Endpoint inside a simulation,
    the real-TCP Endpoint (std/net.py) outside. Both expose the same
    bind/send_to/recv_from/connect1/accept1 surface, which is exactly
    the reference's cfg-switch contract."""
    if in_sim():
        from ..net.endpoint import Endpoint

        return await Endpoint.bind(addr)
    from ..std.net import Endpoint as StdEndpoint

    return await StdEndpoint.bind(addr)
