"""Determinism substrate: stdlib interposition.

The reference achieves "user code is unchanged" determinism by overriding
libc symbols — ``getrandom``/``getentropy`` (madsim/src/sim/rand.rs:174-240),
``gettimeofday``/``clock_gettime`` (sim/time/system_time.rs:6-109) — and by
*forbidding thread creation* inside a simulation (``pthread_attr_init``
panics, sim/task.rs:711-725). Each override checks whether the calling
thread is inside a madsim context and either serves a simulated value or
falls through to the real implementation.

The Python analog interposes at the stdlib layer: module-level functions of
:mod:`random`, :mod:`time`, :mod:`os` entropy/CPU introspection, and
``threading.Thread.start`` are replaced once with dispatchers that check
:func:`madsim_tpu_torch.runtime.context.in_simulation` per call — simulated
behavior inside a runtime, the original behavior everywhere else. This
makes unmodified user code calling ``random.random()`` / ``time.time()`` /
``os.urandom()`` deterministic per seed, including :mod:`uuid` (which draws
from ``os.urandom``).

Known gap (documented, matches the spirit of the reference's ignored Linux
``SYS_getrandom`` test, rand.rs:248-252): C extensions that read entropy or
clocks directly (e.g. ``datetime.datetime.now``) bypass this layer.
"""

from __future__ import annotations

import contextlib
import os
import random as _random_mod
import threading
import time as _time_mod
from typing import Iterator

from . import context

__all__ = ["install", "deterministic_stdlib", "available_parallelism"]

_installed = False
_originals: dict = {}


def _sim_handle():
    return context.try_current_handle()


def available_parallelism() -> int:
    """Core count of the current simulated node (the analog of the
    ``sched_getaffinity``/``sysconf`` overrides, task.rs:659-710)."""
    task = context.try_current_task()
    if task is not None:
        return task.node.cores
    return os.cpu_count() or 1


def _make_random_dispatch(name: str):
    orig = getattr(_random_mod, name)

    def dispatch(*args, **kwargs):
        h = _sim_handle()
        if h is None:
            return orig(*args, **kwargs)
        value = getattr(h.rng._rng, name)(*args, **kwargs)
        h.rng._observe(value if not isinstance(value, list) else tuple(value))
        return value

    dispatch.__name__ = name
    dispatch.__qualname__ = f"madsim_intercept.{name}"
    return orig, dispatch


_RANDOM_FNS = [
    "random",
    "randint",
    "randrange",
    "uniform",
    "choice",
    "getrandbits",
    "randbytes",
    "gauss",
    "normalvariate",
    "expovariate",
    "betavariate",
    "triangular",
    "sample",
    "choices",
]


def install() -> None:
    """Install the dispatchers (idempotent, process-wide).

    Out-of-simulation callers always reach the original implementations,
    mirroring the reference's ``dlsym(RTLD_NEXT, ...)`` passthrough."""
    global _installed
    if _installed:
        return
    _installed = True

    # --- random module (rand.rs:174-240 analog) -------------------------
    for name in _RANDOM_FNS:
        if not hasattr(_random_mod, name):
            continue
        orig, dispatch = _make_random_dispatch(name)
        _originals[("random", name)] = orig
        setattr(_random_mod, name, dispatch)

    # random.shuffle routes through the observed Fisher-Yates
    orig_shuffle = _random_mod.shuffle
    _originals[("random", "shuffle")] = orig_shuffle

    def shuffle(seq):
        h = _sim_handle()
        if h is None:
            return orig_shuffle(seq)
        return h.rng.shuffle(seq)

    _random_mod.shuffle = shuffle

    # random.seed inside a simulation re-seeds the *global* sim RNG stream;
    # forbid it to protect determinism bookkeeping.
    orig_seed = _random_mod.seed
    _originals[("random", "seed")] = orig_seed

    def seed(*args, **kwargs):
        h = _sim_handle()
        if h is None:
            return orig_seed(*args, **kwargs)
        raise RuntimeError(
            "random.seed() is forbidden inside a simulation; the RNG is "
            "seeded by the runtime (use a local random.Random instead)"
        )

    _random_mod.seed = seed

    # --- os entropy / CPU topology --------------------------------------
    orig_urandom = os.urandom
    _originals[("os", "urandom")] = orig_urandom

    def urandom(n: int) -> bytes:
        h = _sim_handle()
        if h is None:
            return orig_urandom(n)
        return h.rng.randbytes(n)

    os.urandom = urandom

    orig_cpu_count = os.cpu_count
    _originals[("os", "cpu_count")] = orig_cpu_count

    def cpu_count():
        t = context.try_current_task()
        if t is not None:
            return t.node.cores
        return orig_cpu_count()

    os.cpu_count = cpu_count

    # --- time module (system_time.rs:6-109 analog) ----------------------
    def _patch_time(name: str, fn):
        orig = getattr(_time_mod, name)
        _originals[("time", name)] = orig

        def dispatch():
            h = _sim_handle()
            if h is None:
                return orig()
            return fn(h)

        dispatch.__name__ = name
        setattr(_time_mod, name, dispatch)

    _patch_time("time", lambda h: (h.time.base_unix_ns + h.time.now_ns()) / 1e9)
    _patch_time("time_ns", lambda h: h.time.base_unix_ns + h.time.now_ns())
    _patch_time("monotonic", lambda h: h.time.now_ns() / 1e9)
    _patch_time("monotonic_ns", lambda h: h.time.now_ns())
    _patch_time("perf_counter", lambda h: h.time.now_ns() / 1e9)
    _patch_time("perf_counter_ns", lambda h: h.time.now_ns())

    # Blocking sleep inside the sim advances the virtual clock
    # synchronously (there is only one OS thread; really sleeping would
    # deadlock the whole simulation).
    orig_sleep = _time_mod.sleep
    _originals[("time", "sleep")] = orig_sleep

    def t_sleep(seconds: float):
        h = _sim_handle()
        if h is None:
            return orig_sleep(seconds)
        h.time._rt.advance(round(seconds * 1e9))

    _time_mod.sleep = t_sleep

    # --- asyncio.as_completed: the ONE stdlib asyncio API whose spawn
    # order is memory-address-dependent (it dedups through set(fs));
    # inside a sim it must spawn in input order or replays diverge —
    # caught by the determinism checker. Everything else in asyncio
    # runs unmodified through the loop interposition (runtime/aio.py).
    import asyncio as _aio_mod

    orig_as_completed = _aio_mod.as_completed
    _originals[("asyncio", "as_completed")] = orig_as_completed

    def as_completed(fs, *, timeout=None):
        if context.in_simulation():
            from . import aio as _aio_impl

            return _aio_impl.deterministic_as_completed(fs, timeout=timeout)
        return orig_as_completed(fs, timeout=timeout)

    _aio_mod.as_completed = as_completed
    _aio_mod.tasks.as_completed = as_completed

    # --- forbid real threads inside the sim (task.rs:711-725) -----------
    orig_start = threading.Thread.start
    _originals[("threading", "start")] = orig_start

    def start(self):
        if context.in_simulation():
            raise RuntimeError(
                "cannot create system threads inside a simulation; "
                "use madsim_tpu_torch.spawn instead"
            )
        return orig_start(self)

    threading.Thread.start = start


@contextlib.contextmanager
def deterministic_stdlib() -> Iterator[None]:
    """Ensure the dispatchers are installed for the duration of a run.

    Installation is permanent and process-wide (dispatch is per-call), so
    this is effectively an install-on-first-use hook with a stable name at
    the runtime entry point."""
    install()
    yield
