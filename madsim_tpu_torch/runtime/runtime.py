"""Runtime, Handle, NodeBuilder, NodeHandle — the supervisor API.

Parity with reference madsim/src/sim/runtime/mod.rs:
  * ``Runtime`` owns GlobalRng + TimeRuntime + Executor and registers the
    default device simulators (FsSim, NetSim) (mod.rs:31-79).
  * ``Runtime.block_on`` enters the context and drives the executor
    (mod.rs:122-125); ``set_time_limit`` (mod.rs:143) bounds virtual time.
  * ``check_determinism`` runs the workload twice with the RNG op-log
    (mod.rs:165-190 + rand.rs:64-110) and raises on the first divergence.
  * ``Handle`` is the cloneable supervisor: seed accessor, kill / restart /
    pause / resume (mod.rs:204-263), node creation.
  * ``NodeBuilder`` configures name/ip/cores/init/restart_on_panic
    (mod.rs:277-360); ``NodeHandle.spawn`` runs tasks on that simulated
    machine (mod.rs:364-383).
"""

from __future__ import annotations

from typing import Any, Callable, Coroutine, Optional, Type, TypeVar

from . import context
from .config import Config
from .plugin import Simulator
from .rand import GlobalRng
from .task import Executor, JoinHandle, NodeInfo
from .time_ import TimeHandle, TimeRuntime

__all__ = ["Runtime", "Handle", "NodeBuilder", "NodeHandle", "DEFAULT_SIMULATORS"]

S = TypeVar("S", bound=Simulator)

# Simulator classes auto-registered on every new Runtime, in registration
# order. The net/fs modules append to this at import time — the analog of
# the reference registering FsSim and NetSim by default
# (runtime/mod.rs:62-64).
DEFAULT_SIMULATORS: list[Type[Simulator]] = []


class Handle:
    """Supervisor handle to a running simulation (mod.rs:204-275)."""

    def __init__(self, runtime: "Runtime"):
        self._runtime = runtime
        self.sims: dict[Type[Simulator], Simulator] = {}

    # -- accessors --------------------------------------------------------
    @property
    def seed(self) -> int:
        return self._runtime.seed

    @property
    def rng(self) -> GlobalRng:
        return self._runtime.rng

    @property
    def time(self) -> TimeHandle:
        return self._runtime.time

    @property
    def config(self) -> Config:
        return self._runtime.config

    @property
    def executor(self) -> Executor:
        return self._runtime.executor

    @staticmethod
    def current() -> "Handle":
        return context.current_handle()

    def simulator(self, cls: Type[S]) -> S:
        return self.sims[cls]  # type: ignore[return-value]

    # -- chaos API (mod.rs:242-263) --------------------------------------
    def _node_id(self, node: "int | str | NodeHandle") -> int:
        """Resolve a node id, handle, or name — the ToNodeId analog
        (task.rs:366-397; unknown names raise like the reference's
        panic)."""
        if isinstance(node, NodeHandle):
            return node.id
        if isinstance(node, str):
            for nid, info in self.executor.nodes.items():
                if info.name == node:
                    return nid
            raise LookupError(f"node not found: {node}")
        return node

    def get_node(self, node: "int | str | NodeHandle") -> "Optional[NodeHandle]":
        """Look up a live node by id/name/handle (mod.rs:271-273)."""
        try:
            nid = self._node_id(node)
        except LookupError:
            return None
        if nid not in self.executor.nodes:
            return None
        return NodeHandle(nid, self)

    def kill(self, node: "int | str | NodeHandle") -> None:
        self.executor.kill_node(self._node_id(node))

    def restart(self, node: "int | str | NodeHandle") -> None:
        self.executor.restart_node(self._node_id(node))

    def pause(self, node: "int | str | NodeHandle") -> None:
        self.executor.pause_node(self._node_id(node))

    def resume(self, node: "int | str | NodeHandle") -> None:
        self.executor.resume_node(self._node_id(node))

    def set_clock_skew(self, node: "int | str | NodeHandle", skew_ns: int) -> None:
        """Chaos: skew the node's wall clock — SystemTime.now() on that
        node reads true time + skew_ns (madsim_tpu_torch.chaos KIND_SKEW)."""
        self.time.set_skew(self._node_id(node), skew_ns)

    def create_node(self) -> "NodeBuilder":
        return NodeBuilder(self)


class NodeHandle:
    """Handle to one simulated machine (mod.rs:364-383)."""

    __slots__ = ("id", "_handle")

    def __init__(self, node_id: int, handle: Handle):
        self.id = node_id
        self._handle = handle

    @property
    def _info(self) -> NodeInfo:
        return self._handle.executor.nodes[self.id]

    @property
    def name(self) -> str:
        return self._info.name

    @property
    def ip(self) -> Optional[str]:
        return self._info.ip

    def spawn(self, coro: Coroutine, name: str = "") -> JoinHandle:
        return self._handle.executor.spawn_on(self._info, coro, name)

    def __repr__(self) -> str:
        return f"NodeHandle(id={self.id}, name={self.name!r})"


class NodeBuilder:
    """Builder for a simulated machine (mod.rs:277-360)."""

    def __init__(self, handle: Handle):
        self._handle = handle
        self._name: Optional[str] = None
        self._ip: Optional[str] = None
        self._cores: int = 1
        self._init: Optional[Callable[[], Coroutine]] = None
        self._restart_on_panic = False

    def name(self, name: str) -> "NodeBuilder":
        self._name = name
        return self

    def ip(self, ip: str) -> "NodeBuilder":
        self._ip = ip
        return self

    def cores(self, cores: int) -> "NodeBuilder":
        if cores < 1:
            raise ValueError("cores must be >= 1")
        self._cores = cores
        return self

    def init(self, factory: Callable[[], Coroutine]) -> "NodeBuilder":
        """Store an init-task factory, re-run on every (re)start
        (mod.rs:307-318). Must be a zero-arg callable returning a fresh
        coroutine (a coroutine object itself is single-use)."""
        if not callable(factory):
            raise TypeError("init expects a zero-arg callable returning a coroutine")
        self._init = factory
        return self

    def restart_on_panic(self, flag: bool = True) -> "NodeBuilder":
        self._restart_on_panic = flag
        return self

    def build(self) -> NodeHandle:
        ex = self._handle.executor
        info = ex.create_node(
            name=self._name,
            init=self._init,
            restart_on_panic=self._restart_on_panic,
            cores=self._cores,
            ip=self._ip,
        )
        if info.init is not None:
            ex.spawn_on(info, info.init(), name=f"init:{info.name}")
        return NodeHandle(info.id, self._handle)


class Runtime:
    """A deterministic simulation runtime for one seed (mod.rs:31-200)."""

    def __init__(self, seed: int = 0, config: Optional[Config] = None):
        self.seed = seed
        self.config = config or Config()
        self.rng = GlobalRng(seed)
        self._time_rt = TimeRuntime(self.rng)
        self.time = TimeHandle(self._time_rt)
        self.executor = Executor(self.rng, self._time_rt)
        self.handle = Handle(self)
        for cls in DEFAULT_SIMULATORS:
            self.add_simulator(cls)

    def add_simulator(self, cls: Type[S]) -> S:
        """Register a device simulator (mod.rs:68-79). Existing nodes get
        their ``create_node`` callback immediately."""
        sim = cls(self.rng, self.time, self.config, self.handle)
        self.handle.sims[cls] = sim
        self.executor.simulators = list(self.handle.sims.values())
        for node_id in self.executor.nodes:
            sim.create_node(node_id)
        return sim

    def create_node(self) -> NodeBuilder:
        return NodeBuilder(self.handle)

    def set_time_limit(self, seconds: float) -> None:
        self.executor.time_limit_ns = round(seconds * 1_000_000_000)

    def block_on(self, coro: Coroutine) -> Any:
        from . import intercept

        with context.enter(self.handle), intercept.deterministic_stdlib():
            return self.executor.block_on(coro)

    @staticmethod
    def check_determinism(
        seed: int,
        workload: Callable[[], Coroutine],
        config: Optional[Config] = None,
        time_limit: Optional[float] = None,
    ) -> Any:
        """Run twice with the RNG op-log; raise DeterminismError on
        divergence (mod.rs:165-190)."""
        from .rand import DeterminismError

        rt1 = Runtime(seed, config)
        if time_limit is not None:
            rt1.set_time_limit(time_limit)
        rt1.rng.enable_log()
        rt1.block_on(workload())
        log = rt1.rng.take_log()

        rt2 = Runtime(seed, config)
        if time_limit is not None:
            rt2.set_time_limit(time_limit)
        rt2.rng.enable_check(log)
        result = rt2.block_on(workload())
        if rt2.rng._check_pos != len(log):
            raise DeterminismError(
                f"non-determinism detected: replay made {rt2.rng._check_pos} "
                f"random draws but the recording has {len(log)}"
            )
        return result
