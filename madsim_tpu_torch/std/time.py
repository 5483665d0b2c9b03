"""Real-clock backend with the simulated time API surface.

Parity with reference madsim/src/std/time.rs (C29): re-exports of the
real runtime's time operations under the sim API names.
"""

from __future__ import annotations

import asyncio
import time as _time

__all__ = ["sleep", "sleep_until", "timeout", "now", "now_ns", "Elapsed"]


class Elapsed(Exception):
    pass


async def sleep(seconds: float) -> None:
    await asyncio.sleep(seconds)


async def sleep_until(deadline_s: float) -> None:
    await asyncio.sleep(max(0.0, deadline_s - _time.monotonic()))  # lint: allow(wall-clock)


async def timeout(seconds: float, awaitable):
    try:
        return await asyncio.wait_for(awaitable, seconds)
    except asyncio.TimeoutError:
        raise Elapsed from None


def now() -> float:
    return _time.monotonic()  # lint: allow(wall-clock)


def now_ns() -> int:
    return _time.monotonic_ns()  # lint: allow(wall-clock)
