"""madsim_tpu_torch: the batched deterministic simulator on PyTorch.

The port of ``madsim_tpu`` (JAX, TPU) to PyTorch and CUDA on an NVIDIA
H100. It imports neither JAX nor anything of ``madsim_tpu``: what it
needs of that package it keeps as its own copy, and its tests hold it
against the JAX package bit for bit.

Layout:

* ``runtime/`` — the single-seed deterministic async runtime: the
  executor, virtual time, the seeded ``GlobalRng``, the stdlib and
  raw-asyncio interposition, node chaos and the ``@test``/``@main``
  harness. It holds no tensors and has no device: it runs on the host.
* ``net/`` — the simulated network (``NetSim``, ``Endpoint``, RPC and
  ``@service``, TCP, UDP, Unix sockets, asyncio streams).
* ``fs.py`` — the simulated per-node filesystem (``FsSim``).
* ``sync`` — the runtime's channels (oneshot, mpsc, watch, broadcast)
  and primitives (``Mutex``, ``RwLock``, ``Semaphore``, ``Notify``,
  ``Barrier``).
* ``compat`` — the asyncio surface that dispatches per call between the
  simulation and the real asyncio (``compat.asyncio``, ``install()``).
* ``std`` — the real backend: wall-clock time, the OS filesystem, the
  TCP ``Endpoint`` and the native transports (epoll, shared memory,
  io_uring), built with g++ from ``native/``.
* ``services`` — the etcd, gRPC and Kafka simulators, each a drop-in
  that runs in a simulation or over real TCP (``services/_dual.py``).
* ``engine`` — ``SimState``, ``make_init``, the plain eager step and
  the runners (``make_run``, ``make_run_while``, seed compaction, seed
  search, measurement, the determinism checks, checkpoints and the
  oracle replay); on a CUDA state the runners launch the hand-written
  run kernel (``engine/fused.py``, sources under ``csrc/``).
* ``models`` — the ported workloads (the ``BENCH_SPECS`` and
  ``SOAK_SPECS`` models, their record, bug, chaos-free and army
  variants).
* ``chaos`` — declarative fault plans (``FaultPlan``, ``LiteralPlan``,
  the client army and its retry policy), compiled with numpy or, with
  ``compile_batch(device=True)``, with torch ops on the seeds' device;
  ``shrink_plan``; the ``Nemesis``, which applies a plan's events to a
  single-seed ``Runtime``.
* ``check`` — the history checkers and their device screens; the
  ``Recorder``, which records a runtime application's history in the
  engine's representation, so that one checker judges both modes.
* ``explore`` — coverage-guided exploration: the host driver ``run``,
  the device campaign ``run_device``, mutation, admission and campaign
  checkpoints.
* ``obs`` — the timeline ring's decoder, the latency sketch, causal
  provenance, fleet metrics and Perfetto documents; campaign telemetry
  and ``explain``, the program profiler and the flight recorder.
* ``farm`` — power schedules (``EnergySchedule``, ``FarmEnergy``), the
  pipelined device campaign (``run_pipelined``) and the multi-tenant
  scheduler (``run_farm``).
* ``parallel`` — seed sharding over a ``torch.distributed`` world
  (``make_mesh``, ``shard_state``, ``shard_run_compacted``) and the
  fleet merges, on one device or across the world.
"""


from .runtime import (  # noqa: F401
    Builder,
    Config,
    DeadlockError,
    DeterminismError,
    Elapsed,
    FallibleTask,
    Handle,
    Instant,
    Interval,
    JoinError,
    JoinHandle,
    NetConfig,
    NodeBuilder,
    NodeHandle,
    Runtime,
    SimContextFilter,
    SimFormatter,
    SimFuture,
    Simulator,
    SystemTime,
    TimeLimitError,
    available_parallelism,
    init_logger,
    interval,
    join_all,
    main,
    node,
    now,
    now_ns,
    random,
    select,
    simulator,
    sleep,
    sleep_until,
    span,
    spawn,
    spawn_blocking,
    spawn_local,
    test,
    thread_rng,
    timeout,
    yield_now,
)

# Importing the device-simulator modules registers them as default
# simulators on every Runtime (reference runtime/mod.rs:62-64).
from . import fs  # noqa: E402,F401
from . import net  # noqa: E402,F401
from . import sync  # noqa: E402,F401
from .fs import FsSim  # noqa: F401
from .net import Endpoint, NetSim, TcpListener, TcpStream, UdpSocket  # noqa: F401

from . import chaos, check, engine, explore, farm, models, obs, parallel  # noqa: E402,F401
