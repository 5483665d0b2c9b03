"""Single-seed deterministic simulation runtime (the madsim-core parity
layer; reference: madsim/src/sim/)."""

from .builder import Builder, main, test
from .config import Config, NetConfig, TcpConfig
from .context import current_handle, in_simulation, try_current_handle
from .future import Cancelled, SimFuture, join_all, select
from .intercept import available_parallelism
from .plugin import Simulator, node, simulator
from .rand import DeterminismError, GlobalRng, random, thread_rng
from .runtime import DEFAULT_SIMULATORS, Handle, NodeBuilder, NodeHandle, Runtime
from .trace import SimContextFilter, SimFormatter, init_logger, span
from .task import (
    DeadlockError,
    FallibleTask,
    JoinError,
    JoinHandle,
    TimeLimitError,
    spawn,
    spawn_blocking,
    spawn_local,
    yield_now,
)
from .time_ import (
    Elapsed,
    Instant,
    Interval,
    MissedTickBehavior,
    SystemTime,
    interval,
    now,
    now_ns,
    sleep,
    sleep_until,
    timeout,
)

__all__ = [
    "Builder",
    "Cancelled",
    "Config",
    "DEFAULT_SIMULATORS",
    "DeadlockError",
    "DeterminismError",
    "Elapsed",
    "GlobalRng",
    "Handle",
    "Instant",
    "Interval",
    "JoinError",
    "JoinHandle",
    "MissedTickBehavior",
    "NetConfig",
    "NodeBuilder",
    "NodeHandle",
    "Runtime",
    "SimFuture",
    "SimContextFilter",
    "SimFormatter",
    "Simulator",
    "SystemTime",
    "TcpConfig",
    "TimeLimitError",
    "available_parallelism",
    "current_handle",
    "in_simulation",
    "init_logger",
    "interval",
    "join_all",
    "main",
    "node",
    "now",
    "now_ns",
    "random",
    "select",
    "simulator",
    "span",
    "sleep",
    "sleep_until",
    "FallibleTask",
    "spawn",
    "spawn_blocking",
    "spawn_local",
    "yield_now",
    "test",
    "thread_rng",
    "timeout",
    "try_current_handle",
]
