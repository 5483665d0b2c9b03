"""Multi-seed test harness.

Parity with reference madsim/src/sim/runtime/builder.rs and
madsim-macros/src/lib.rs:
  * ``Builder.from_env`` reads ``MADSIM_TEST_SEED`` / ``MADSIM_TEST_NUM`` /
    ``MADSIM_TEST_JOBS`` / ``MADSIM_TEST_CONFIG`` /
    ``MADSIM_TEST_TIME_LIMIT`` / ``MADSIM_TEST_CHECK_DETERMINISM``
    (builder.rs:23-107).
  * ``Builder.run`` executes the workload for ``count`` consecutive seeds,
    one OS thread per simulation for context isolation, up to ``jobs``
    concurrently (builder.rs:110-148).
  * A failing seed prints the repro banner with the seed and the config
    hash before re-raising (runtime/mod.rs:193-200 ``panic_with_info``).
  * ``@madsim_tpu_torch.test`` / ``@madsim_tpu_torch.main`` are the analogs of
    ``#[madsim::test]`` / ``#[madsim::main]`` (madsim-macros/src/lib.rs:
    36-113): the decorated ``async def`` becomes a plain callable that
    pytest (or ``__main__``) invokes directly.
"""

from __future__ import annotations

import functools
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Coroutine, Optional

from .config import Config
from .runtime import Runtime

__all__ = ["Builder", "test", "main"]


class Builder:
    def __init__(
        self,
        seed: Optional[int] = None,
        count: int = 1,
        jobs: int = 1,
        config: Optional[Config] = None,
        time_limit: Optional[float] = None,
        check_determinism: bool = False,
    ):
        if seed is None:
            # Default seed comes from real OS entropy, like the reference
            # (builder.rs:58-60); set MADSIM_TEST_SEED to pin it.
            # real entropy is the POINT here (builder.rs:58-60); every
            # in-sim draw then derives from this one pinned seed
            seed = int.from_bytes(os.urandom(8), "little") % (1 << 32)  # lint: allow(ambient-entropy)
        self.seed = seed
        self.count = count
        self.jobs = jobs
        self.config = config or Config()
        self.time_limit = time_limit
        self.check_determinism = check_determinism

    @classmethod
    def from_env(cls) -> "Builder":
        seed_s = os.environ.get("MADSIM_TEST_SEED")
        config = None
        config_path = os.environ.get("MADSIM_TEST_CONFIG")
        if config_path:
            config = Config.from_file(config_path)
        time_limit_s = os.environ.get("MADSIM_TEST_TIME_LIMIT")
        return cls(
            seed=int(seed_s) if seed_s else None,
            count=int(os.environ.get("MADSIM_TEST_NUM", "1")),
            jobs=int(os.environ.get("MADSIM_TEST_JOBS", "1")),
            config=config,
            time_limit=float(time_limit_s) if time_limit_s else None,
            check_determinism=bool(os.environ.get("MADSIM_TEST_CHECK_DETERMINISM")),
        )

    def _run_one(self, seed: int, workload: Callable[[], Coroutine]) -> Any:
        try:
            if self.check_determinism:
                return Runtime.check_determinism(
                    seed, workload, config=self.config, time_limit=self.time_limit
                )
            rt = Runtime(seed, self.config)
            if self.time_limit is not None:
                rt.set_time_limit(self.time_limit)
            return rt.block_on(workload())
        except BaseException:
            # Repro banner (runtime/mod.rs:193-200).
            print(
                f"\nnote: rerun with `MADSIM_TEST_SEED={seed}` to reproduce"
                f" this failure\n      config hash: {self.config.hash():016x}",
                file=sys.stderr,
            )
            raise

    def run(self, workload: Callable[[], Coroutine]) -> Any:
        """Run ``count`` consecutive seeds; returns the last result."""
        seeds = [self.seed + i for i in range(self.count)]
        if self.jobs <= 1 or len(seeds) == 1:
            result = None
            for s in seeds:
                result = self._run_one(s, workload)
            return result
        # One simulation per worker thread — thread-local context gives the
        # same isolation as the reference's thread-per-seed model
        # (builder.rs:118-136).
        with ThreadPoolExecutor(max_workers=self.jobs) as pool:
            futures = [pool.submit(self._run_one, s, workload) for s in seeds]
            result = None
            for f in futures:
                result = f.result()
            return result


def test(fn: Optional[Callable[..., Coroutine]] = None, **builder_kwargs):
    """Decorator: turn an ``async def`` test into a seeded simulation run.

    Analog of ``#[madsim::test]`` (madsim-macros/src/lib.rs:88-96). Keyword
    arguments override the env-derived :class:`Builder` fields, e.g.
    ``@madsim_tpu_torch.test(count=16, time_limit=300)``.
    """

    def deco(f: Callable[..., Coroutine]):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            from .trace import init_logger

            init_logger()  # the test macro inits the subscriber once
            b = Builder.from_env()
            for k, v in builder_kwargs.items():
                setattr(b, k, v)
            return b.run(lambda: f(*args, **kwargs))

        wrapper.__madsim_test__ = True  # type: ignore[attr-defined]
        return wrapper

    return deco(fn) if fn is not None else deco


def main(fn: Callable[..., Coroutine]):
    """Decorator analog of ``#[madsim::main]`` (madsim-macros/src/lib.rs:
    36-86): run the body once on the env-selected seed."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        b = Builder.from_env()
        b.count = 1
        return b.run(lambda: fn(*args, **kwargs))

    return wrapper
