"""The fused run kernel: the whole step loop in one CUDA launch.

Port of ``madsim_tpu/engine/vmem.py:make_run_vmem``, the JAX package's
one Pallas kernel, which runs ``n_steps`` of ``vmap(make_step)`` with
each block of seeds' state resident on chip. On the H100 the kernel is
hand-written CUDA C++ for ``sm_90a``: a block holds 128 / G seeds'
state in shared memory for the whole loop, and each seed runs on a
group of G lanes (``GROUP``). The engine step is generic
(``csrc/engine_step.cuh``, ``csrc/lanes.cuh``); each workload it carries
is a model trait with its handlers as device code (``csrc/model_*.cuh``),
listed in :data:`MODELS` by library key (the factories' default and
record variants, and the ``chaos=False`` variants that fault plans
drive, some built with the duplication rows of ``dup_rows``, and
leasekv-record's whose client may stall its keepalives). Any
other workload, or a registered one at another shape, raises
``NotImplementedError`` on a CUDA state.

Each model's kernel is its own library, built with nvcc on first use
into ``build/kernels/<hash>/`` at the root of the checkout (keyed by a
hash of the sources, the generated unit and the flags) and loaded with
ctypes. A CPU state runs the plain eager step instead
(``core.make_run_plain``); a CUDA state never does.

The kernel reads its input state and writes fresh outputs allocated
with ``torch.empty``; ``seed``, which it never writes, is shared with
the input, as the plain step shares it. The chaos columns ``slow``,
``skew`` and ``dup`` are written on every run, plan or not.

A workload with a ``HistorySpec`` runs on its record library (a model
trait with ``R > 0`` record rows a call): the kernel appends its
history records as the plain step does, and the history columns are
fresh outputs; a workload without one shares its zero-size history
columns, and its ``hist_count`` and ``hist_drop``, with the input.

A workload with the sync discipline (``Workload.durable_sync``) runs on
a library whose trait keeps it (``SYNC``): the storage columns
(``STORAGE_FIELDS``) are fresh outputs; any other shares its zero-size
ones with the input. A state from ``make_init(metrics=True)`` (its
``met`` row of ``N_METRICS`` slots, ``has_metrics``) launches each
library's second instantiation of the run kernel, which folds the
``MET_*`` counters into a fresh ``met``; a state without the row shares
its zero-size ``met`` with the input. The run's ``metrics=`` must agree
with the row, or the wrapper raises.

The coverage taps and the timeline ring are a third instantiation of
the run kernel, built only at a library's ``obs_pools`` (the libraries
and pools that ``chip_smoke.py`` and the card tests drive with them), so
every other kernel is compiled as before. A state with a coverage or
ring column (``has_obs``) launches it, and raises
``NotImplementedError`` at any other library or pool. Its widths are
runtime words: the state's ``cov``, ``cov_hits`` and ``tl_t`` columns
give the kernel ``cov_words``, the hit-count flag and ``timeline_cap``
(config words 9-11, :func:`kernel_args`), which the run's arguments
must match. Their columns are fresh outputs when the tap is on and the
input's (zero-size, or for the ring's counters zero) columns when it is
off. A model's own coverage features (``Workload.cov_features``) are
its trait's ``cov_features``: leasekv and shardkv always, raftlog in
the ``cov_spread`` library.

Causal provenance rides the same instantiation as a runtime word
(config word 15): a state from ``make_init(causal=True)`` (its ``lam``
has a column per node, ``core.causal_on``) launches the taps kernel,
and so raises at a library or pool without one. The kernel keeps
``lam`` and the pool's ``ev_parent`` and ``ev_lam`` in the seed's
shared tail, writes the sidecars wherever placement fills a slot (ring
or no ring), folds the Lamport clock on every dispatch to a node in
range, taps the (depth, jump) feature under tag 7 with coverage on, and
writes the ring's ``tl_seq``, ``tl_parent`` and ``tl_lam`` straight to
the output. The six columns are fresh outputs with the axis on and the
input's zero-size ones with it off.

The tail-latency tap needs no instantiation of its own: it compiles
into the libraries whose workload marks ops (``Workload.lat_markers``,
the trait's ``L``: the army libraries), and every other library is built
as before. Its widths are runtime words 12-14 (the state's ``lat_inv``
and ``lat_hist`` widths and the run's ``LatencySpec.phase_ns``). On a
library with markers and the tap on, the five ``lat_*`` columns are
fresh outputs; otherwise they are the input's, which a run cannot
change (a workload without markers folds nothing).

The client-retry timers compile into the same libraries, those with
markers, and only those: a state from ``make_init(retry=...)`` carries
the three retry columns, the run's ``RetrySpec`` rides the config words
after the causal word (:func:`retry_words`, zeros without a policy), and
the columns are fresh outputs with a policy and the input's zero-size
ones without. A retry state on a library without markers, or at a shape
or pool without a library, raises; it never runs the plain step.

``make_run_while`` semantics: the JAX loop runs every seed for the same
``T = min(cap, steps until every seed has halted)`` iterations, and a
halted seed's iteration still consumes its earliest slot and counts a
step. The wrapper makes two launches: the run kernel runs every seed
until it halts (or the cap), reports its count and leaves ``T``, the
largest, in a device word; then the drain kernel gives each seed its
remaining ``T - count`` halted steps, touching only ``step``,
``ev_valid`` and ``ev_time``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .core import (
    CAUSAL_STATE_FIELDS,
    COVERAGE_FIELDS,
    LATENCY_FIELDS,
    N_LAT_BUCKETS,
    N_METRICS,
    RETRY_ATTEMPT_MAX,
    RETRY_STATE_FIELDS,
    STATE_FIELDS,
    STORAGE_FIELDS,
    TIMELINE_FIELDS,
    EngineConfig,
    SimState,
    Workload,
    causal_on,
    check_causal_state,
    check_lat_state,
    check_obs_state,
    check_retry_state,
    host_to_device,
    lat_widths,
    make_run_plain,
    make_run_while_plain,
    obs_widths,
    retry_width,
    _retry_backoff_tables,
)

__all__ = [
    "KERNEL",
    "KERNEL_FIELDS",
    "MODELS",
    "NVCC_FLAGS",
    "HISTORY_COLUMNS",
    "KernelModel",
    "RunKernel",
    "build_libraries",
    "build_library",
    "check_state",
    "drain_plain",
    "fresh_outputs",
    "config_words",
    "halt_counts",
    "kernel_args",
    "kernel_model",
    "check_taps",
    "has_obs",
    "make_run_fused",
    "obs_words",
    "workload_shape",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
ENGINE_SOURCES = (
    "threefry.cuh", "lanes.cuh", "engine_step.cuh", "run_kernel.cu",
)
# lanes per seed for every model; a model may set its own in MODELS (the
# measured choice: PERF.md, section 6)
GROUP = 8
BUILD_ROOT = _PKG.parent / "build" / "kernels"
# a handler left without MADSIM_HD would build as a host function that
# the device step cannot call: nvcc only warns, and the kernel would run
# without it, so that warning is an error
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--resource-usage",
    "--Werror", "cross-execution-space-call",
)


@dataclasses.dataclass(frozen=True)
class KernelModel:
    """One workload the run kernel carries, and how its library is built.

    ``shape`` is :func:`workload_shape` of the factory's workload at the
    compiled variant; ``words`` name the ``model_params`` passed to the
    kernel as runtime words (the model trait's ``Params`` order);
    ``fixed`` are ``model_params`` the library is compiled for."""

    key: str  # library name, libmadsim_<key>.so
    name: str  # Workload.name
    header: str  # csrc/model_*.cuh
    cxx: str  # the C++ model trait
    shape: tuple
    pools: tuple  # pool sizes instantiated
    words: tuple = ()
    fixed: tuple = ()
    group: int = GROUP  # lanes per seed
    dup: bool = False  # built with the duplication rows (dup_rows=True)
    sync: bool = False  # the trait keeps the sync discipline (durable_sync)
    obs_pools: tuple = ()  # pools with the observability kernel (the taps)
    lat: int = 0  # latency-marker rows a call (the trait's L, Workload.lat_markers)

    def draws_source(self) -> str:
        """C++ naming the workload's declared user draw purposes
        (``UserDraws`` in csrc/engine_step.cuh); empty when it has
        none."""
        purposes = self.shape[6]
        if not purposes:
            return ""
        listed = ", ".join(f"{p}u" for p in purposes)
        return (
            f"namespace madsim {{\n"
            f"template <> struct UserDraws<{self.cxx}> {{\n"
            f"  static constexpr int n = {len(purposes)};\n"
            f"  static MADSIM_HDI uint32_t purpose(int d) {{\n"
            f"    constexpr uint32_t p[] = {{{listed}}};\n"
            f"    return p[d];\n"
            f"  }}\n"
            f"}};\n"
            f"}}  // namespace madsim\n"
        )

    def traits_source(self) -> str:
        """C++ specializing the engine's per-model traits: the declared
        user draws and, for a ``dup`` library, ``DupRows`` (K shadow
        rows)."""
        if not self.dup:
            return self.draws_source()
        return self.draws_source() + (
            f"namespace madsim {{\n"
            f"template <> struct DupRows<{self.cxx}> {{\n"
            f"  static constexpr int n = {self.cxx}::K;\n"
            f"}};\n"
            f"}}  // namespace madsim\n"
        )

    def unit_source(self) -> str:
        """The translation unit nvcc compiles for this model."""
        return (
            f"// run kernel unit for {self.key}, written by engine/fused.py\n"
            f'#include "{self.header}"\n'
            f"{self.traits_source()}"
            f"#define MADSIM_MODEL {self.cxx}\n"
            f"#define MADSIM_POOLS {', '.join(str(p) for p in self.pools)}\n"
            f"#define MADSIM_GROUP {self.group}\n"
            f"#define MADSIM_OBS_POOLS {', '.join(str(p) for p in self.obs_pools)}\n"
            f'#include "run_kernel.cu"\n'
        )


# (n_nodes, state_width, args_words, payload_words, max_emits,
#  handlers, draw_purposes, history records a call) at each factory's
# default variant and at its record (and bug) variants; pools: the
# model's BENCH_SPECS or SOAK_SPECS pool, for raft also the pools of the
# entry shape and the tests (and raft-record's of the nemesis soak), and
# for kvchaos's record variants also the pool of the JAX package's
# history-search tests. Then the chaos-plan libraries: the chaos=False
# variants that fault plans drive (tools/nemesis_soak.py's certificates,
# the port's plan tests), at the pools of those runs (96: the JAX tests'
# kv_cfg and the soak's paxos and twophase; 192: the soak's kvchaos), two
# of them also built with the duplication rows. A variant may share its
# workload name with its chaos=True sibling: MODELS is keyed by library.
_KV_FIXED = (("n_replicas", 4), ("chaos", True), ("payload", False))
_LEASE_FIXED = (("n_clients", 3), ("chaos", True), ("ka_stop_ms", None))
_SHARD_FIXED = (("n_groups", 4), ("group_size", 3), ("n_shards", 8), ("chaos", True))
_KV_WORDS = ("writes", "retx_ns", "client_retx_ns")
_LEASE_WORDS = ("puts", "ttl_ms", "ka_ms", "scan_ms", "put_ms")
_SHARD_WORDS = ("writes", "n_migs", "put_ms", "mig_ms", "retx_ms")
_RAFTLOG_WORDS = ("timeout_min_ns", "timeout_max_ns", "propose_ns", "retx_ns")
_RAFTLOG_FIXED = (("n_nodes", 5), ("n_writes", 4), ("chaos", True), ("durable", False),
                  ("cov_spread", False))
_RAFTLOG_STORE_SHAPE = (5, 12, 4, 4, 7, 8, (0, 1), 4)
_RAFTLOG_STORE = (("n_nodes", 5), ("n_writes", 4), ("chaos", False), ("durable", True),
                  ("cov_spread", False))
_RAFTLOG_DURABLE = (("n_nodes", 5), ("n_writes", 4), ("chaos", True), ("durable", True))
_RAFTLOG_NOCHAOS = (("n_nodes", 5), ("n_writes", 4), ("chaos", False), ("durable", False),
                    ("cov_spread", False))
_TWOPHASE_WORDS = ("txns", "no_pct", "retx_ns", "revive_min_ns", "revive_max_ns")
_PAXOS_WORDS = ("start_min_ns", "start_max_ns", "timeout_min_ns",
                "timeout_max_ns", "kill_min_ns", "kill_max_ns",
                "revive_min_ns", "revive_max_ns")
_PAXOS_FIXED = (("n_acceptors", 5), ("n_proposers", 3), ("chaos", True),
                ("durable_acceptors", False))
_KV_NOCHAOS = (("n_replicas", 4), ("chaos", False), ("payload", False))
_KV_NOCHAOS_SHAPE = (6, 4, 2, 0, 6, 12, (), 3)
_TP_NOCHAOS_SHAPE = (5, 6, 3, 0, 10, 9, (), 1)
_TP_NOCHAOS = (("n_parts", 4), ("chaos", False))
# the client-army libraries (make_*(army=True)), each with one latency
# marker a call: the latency soak's kvchaos at pool 160, the step
# goldens' kvchaos and raftlog army scenarios with the taps, leasekv
# with its family's fixed words, and shardkv-record without its own chaos
_KV_ARMY_SOAK = (("n_replicas", 2), ("chaos", False), ("payload", False), ("record", False),
                 ("army", True), ("army_probes", 3))
_KV_ARMY_GOLDEN = (*_KV_FIXED, ("record", True), ("bug", False), ("army", True),
                   ("army_probes", 2))
_LEASE_ARMY = (*_LEASE_FIXED, ("record", False), ("army", True), ("army_probes", 1))
# leasekv-record without its own chaos, whose client 1 may stall its
# keepalives: the etcd lease convergence (tests/test_leasekv.py's
# dual-mode scenario) at the soak's pool; ka_stop_ms is a word, and
# None passes NO_WORD
_LEASE_NOCHAOS = (("n_clients", 3), ("chaos", False), ("record", True), ("bug", False),
                  ("army", False))
# a runtime word whose parameter is None: past any clock a trait compares
# it with
NO_WORD = (1 << 63) - 1
_RAFTLOG_W16_SHAPE = (5, 24, 4, 16, 7, 8, (0, 1), 16)
_RAFTLOG_W16 = (("n_nodes", 5), ("n_writes", 16), ("chaos", False), ("durable", False),
                ("cov_spread", False))
_SHARD_ARMY = (("n_groups", 4), ("group_size", 3), ("n_shards", 8), ("chaos", False),
               ("record", True), ("bug", False), ("army", True), ("army_probes", 1))
# the retry soak's (tools/retry_soak.py): kvchaos-record army with two
# replicas and one probe, without its own chaos, and the noidem mutant of
# its shardkv army
_KV_ARMY_RETRY = (("n_replicas", 2), ("chaos", False), ("payload", False), ("record", True),
                  ("bug", False), ("army", True), ("army_probes", 1))
_SHARD_NOIDEM = (*_SHARD_ARMY[:5], ("bug", "noidem"), *_SHARD_ARMY[6:])
MODELS = {
    m.key: m
    for m in (
        KernelModel(
            "raft", "raft-election", "model_raft.cuh", "madsim::RaftModel<false>",
            (5, 6, 2, 0, 6, 5, (0,), 0), (40, 64, 128, 256),
            ("timeout_min_ns", "timeout_max_ns"), (("n_nodes", 5),), obs_pools=(40, 64),
        ),
        KernelModel(
            "raft-record", "raft-election-record", "model_raft.cuh",
            "madsim::RaftModel<true>", (5, 6, 2, 0, 6, 5, (0,), 1), (40, 64),
            ("timeout_min_ns", "timeout_max_ns"), (("n_nodes", 5),),
        ),
        KernelModel(
            "microbench", "microbench", "model_microbench.cuh",
            "madsim::MicrobenchModel", (1, 4, 2, 0, 2, 2, (0, 1), 0), (32,),
            ("rounds", "delay_min_ns", "delay_max_ns"),
        ),
        KernelModel(
            "pingpong", "pingpong", "model_pingpong.cuh",
            "madsim::PingpongModel", (3, 4, 2, 0, 2, 4, (), 0), (32,),
            ("rounds",), (("n_clients", 2),),
        ),
        KernelModel(
            "broadcast", "broadcast", "model_broadcast.cuh",
            "madsim::BroadcastModel", (5, 4, 2, 0, 7, 4, (1, 17, 2, 3), 0),
            (40,), ("rounds", "retx_ns"),
            (("n_nodes", 5), ("partition", True)),
        ),
        KernelModel(
            "kvchaos", "kvchaos", "model_kvchaos.cuh",
            "madsim::KvChaosModel<false>", (6, 4, 2, 0, 6, 12, (0, 1, 2), 0),
            (40,), _KV_WORDS, _KV_FIXED,
        ),
        KernelModel(
            "kvchaos-payload", "kvchaos-payload", "model_kvchaos.cuh",
            "madsim::KvChaosModel<true>",
            (6, 6, 2, 2, 6, 12, (0, 1, 2, 8, 9), 0), (40,), _KV_WORDS,
            (("n_replicas", 4), ("chaos", True), ("payload", True)),
        ),
        KernelModel(
            "kvchaos-record", "kvchaos-record", "model_kvchaos.cuh",
            "madsim::KvChaosModel<false, true, false>",
            (6, 4, 2, 0, 6, 12, (0, 1, 2), 3), (40, 192), _KV_WORDS,
            (*_KV_FIXED, ("record", True), ("bug", False)),
        ),
        KernelModel(
            "kvchaos-bug", "kvchaos-bug", "model_kvchaos.cuh",
            "madsim::KvChaosModel<false, true, true>",
            (6, 4, 2, 0, 6, 12, (0, 1, 2), 3), (40, 192), _KV_WORDS,
            (*_KV_FIXED, ("record", True), ("bug", True)),
        ),
        KernelModel(
            "raftlog", "raftlog", "model_raftlog.cuh", "madsim::RaftLogModel<false>",
            (5, 12, 4, 4, 7, 8, (0, 1, 2, 3, 4), 0), (64,),
            _RAFTLOG_WORDS, _RAFTLOG_FIXED,
        ),
        KernelModel(
            "raftlog-record", "raftlog-record", "model_raftlog.cuh",
            "madsim::RaftLogModel<true>",
            (5, 12, 4, 4, 7, 8, (0, 1, 2, 3, 4), 4), (64,),
            _RAFTLOG_WORDS, _RAFTLOG_FIXED,
        ),
        KernelModel(
            "snapshot", "snapshot", "model_snapshot.cuh",
            "madsim::SnapshotModel", (5, 6, 2, 0, 6, 5, (), 0), (96,),
            ("n_sends", "balance", "amount_max", "send_min_ns",
             "send_max_ns", "snap_min_ns", "snap_max_ns"),
            (("n_nodes", 5),),
        ),
        KernelModel(
            "twophase", "twophase", "model_twophase.cuh",
            "madsim::TwoPhaseModel<false>", (5, 6, 3, 0, 10, 9, (), 0), (64,),
            _TWOPHASE_WORDS, (("n_parts", 4), ("chaos", True)),
        ),
        KernelModel(
            "twophase-record", "twophase-record", "model_twophase.cuh",
            "madsim::TwoPhaseModel<true>", (5, 6, 3, 0, 10, 9, (), 1), (64,),
            _TWOPHASE_WORDS, (("n_parts", 4), ("chaos", True)),
        ),
        KernelModel(
            "paxos", "paxos", "model_paxos.cuh", "madsim::PaxosModel<false>",
            (8, 10, 3, 0, 7, 8, (0, 1, 2, 3, 4), 0), (64,),
            _PAXOS_WORDS, _PAXOS_FIXED,
        ),
        KernelModel(
            "paxos-record", "paxos-record", "model_paxos.cuh",
            "madsim::PaxosModel<true>", (8, 10, 3, 0, 7, 8, (0, 1, 2, 3, 4), 1),
            (64,), _PAXOS_WORDS, _PAXOS_FIXED,
        ),
        KernelModel(
            "leasekv", "leasekv", "model_leasekv.cuh", "madsim::LeaseKvModel<false>",
            (5, 6, 2, 0, 6, 15, (0, 1, 2), 0), (48,), _LEASE_WORDS, _LEASE_FIXED,
            obs_pools=(48,),
        ),
        KernelModel(
            "leasekv-record", "leasekv-record", "model_leasekv.cuh",
            "madsim::LeaseKvModel<true, false>", (5, 6, 2, 0, 6, 15, (0, 1, 2), 3),
            (48,), _LEASE_WORDS, (*_LEASE_FIXED, ("record", True), ("bug", False)),
        ),
        KernelModel(
            "leasekv-bug", "leasekv-bug", "model_leasekv.cuh",
            "madsim::LeaseKvModel<true, true>", (5, 6, 2, 0, 6, 15, (0, 1, 2), 3),
            (48,), _LEASE_WORDS, (*_LEASE_FIXED, ("record", True), ("bug", True)),
        ),
        KernelModel(
            "shardkv", "shardkv", "model_shardkv.cuh", "madsim::ShardKvModel<false>",
            (14, 17, 3, 0, 6, 15, (0, 1, 2), 0), (64,), _SHARD_WORDS, _SHARD_FIXED,
            obs_pools=(64,),
        ),
        KernelModel(
            "shardkv-record", "shardkv-record", "model_shardkv.cuh",
            "madsim::ShardKvModel<true, false>", (14, 17, 3, 0, 6, 15, (0, 1, 2), 1),
            (64,), _SHARD_WORDS, (*_SHARD_FIXED, ("record", True), ("bug", False)),
        ),
        KernelModel(
            "shardkv-bug", "shardkv-bug", "model_shardkv.cuh",
            "madsim::ShardKvModel<true, true>", (14, 17, 3, 0, 6, 15, (0, 1, 2), 1),
            (64,), _SHARD_WORDS, (*_SHARD_FIXED, ("record", True), ("bug", True)),
        ),
        KernelModel(
            "kvchaos-record-nochaos", "kvchaos-record", "model_kvchaos.cuh",
            "madsim::KvChaosModel<false, true, false, false>", _KV_NOCHAOS_SHAPE,
            (96, 192), _KV_WORDS, (*_KV_NOCHAOS, ("record", True), ("bug", False)),
        ),
        KernelModel(
            "kvchaos-bug-nochaos", "kvchaos-bug", "model_kvchaos.cuh",
            "madsim::KvChaosModel<false, true, true, false>", _KV_NOCHAOS_SHAPE,
            (96, 192), _KV_WORDS, (*_KV_NOCHAOS, ("record", True), ("bug", True)),
            obs_pools=(192,),
        ),
        KernelModel(
            "kvchaos-record-nochaos-dup", "kvchaos-record", "model_kvchaos.cuh",
            "madsim::KvChaosModel<false, true, false, false>", _KV_NOCHAOS_SHAPE,
            (96, 192), _KV_WORDS, (*_KV_NOCHAOS, ("record", True), ("bug", False)),
            dup=True,
        ),
        KernelModel(
            "paxos-record-nochaos", "paxos-record", "model_paxos.cuh",
            "madsim::PaxosModel<true, false>", (8, 10, 3, 0, 7, 8, (0, 1), 1), (96,),
            _PAXOS_WORDS, (("n_acceptors", 5), ("n_proposers", 3), ("chaos", False),
                           ("durable_acceptors", False)),
        ),
        KernelModel(
            "twophase-record-nochaos", "twophase-record", "model_twophase.cuh",
            "madsim::TwoPhaseModel<true, false>", _TP_NOCHAOS_SHAPE, (96,),
            _TWOPHASE_WORDS, _TP_NOCHAOS,
        ),
        KernelModel(
            "twophase-record-nochaos-dup", "twophase-record", "model_twophase.cuh",
            "madsim::TwoPhaseModel<true, false>", _TP_NOCHAOS_SHAPE, (96,),
            _TWOPHASE_WORDS, _TP_NOCHAOS, dup=True,
        ),
        # the storage libraries: raftlog durable=True with its own chaos
        # (the raftlog bench pool and the store soak's), and the store
        # soak's record variants without it, correct and nosync
        KernelModel(
            "raftlog-durable", "raftlog", "model_raftlog.cuh",
            "madsim::RaftLogModel<false, true, true>",
            (5, 12, 4, 4, 7, 8, (0, 1, 2, 3, 4), 0), (64, 128), _RAFTLOG_WORDS,
            (*_RAFTLOG_DURABLE, ("cov_spread", False)), sync=True,
        ),
        # raftlog durable=True with cov_spread: its coverage features are
        # the trait's (the coverage searches of the card's smoke run)
        KernelModel(
            "raftlog-durable-spread", "raftlog", "model_raftlog.cuh",
            "madsim::RaftLogModel<false, true, true, false, true>",
            (5, 12, 4, 4, 7, 8, (0, 1, 2, 3, 4), 0), (64,), _RAFTLOG_WORDS,
            (*_RAFTLOG_DURABLE, ("cov_spread", True)), sync=True, obs_pools=(64,),
        ),
        KernelModel(
            "raftlog-durable-record", "raftlog-record", "model_raftlog.cuh",
            "madsim::RaftLogModel<true, false, true>", _RAFTLOG_STORE_SHAPE, (96, 128),
            _RAFTLOG_WORDS, _RAFTLOG_STORE, sync=True,
        ),
        KernelModel(
            "raftlog-nosync-record", "raftlog-nosync-record", "model_raftlog.cuh",
            "madsim::RaftLogModel<true, false, true, true>", _RAFTLOG_STORE_SHAPE, (128,),
            _RAFTLOG_WORDS, (*_RAFTLOG_STORE, ("bug", "nosync")), sync=True,
            obs_pools=(128,),
        ),
        KernelModel(
            "kvchaos-army-nochaos", "kvchaos-army", "model_kvchaos.cuh",
            "madsim::KvChaosModel<false, false, false, false, true, 2, 3>",
            (4, 4, 2, 0, 6, 15, (), 0), (160,), _KV_WORDS, _KV_ARMY_SOAK, obs_pools=(160,),
            lat=1,
        ),
        KernelModel(
            "kvchaos-record-army", "kvchaos-record-army", "model_kvchaos.cuh",
            "madsim::KvChaosModel<false, true, false, true, true, 4, 2>",
            (6, 4, 2, 0, 6, 15, (0, 1, 2), 3), (72,), _KV_WORDS, _KV_ARMY_GOLDEN,
            obs_pools=(72,), lat=1,
        ),
        KernelModel(
            "raftlog-record-army", "raftlog-record-army", "model_raftlog.cuh",
            "madsim::RaftLogModel<true, true, false, false, false, true>",
            (6, 12, 4, 4, 7, 11, (0, 1, 2, 3, 4), 4), (96,), _RAFTLOG_WORDS,
            (*_RAFTLOG_FIXED, ("army", True)), obs_pools=(96,), lat=1,
        ),
        KernelModel(
            "leasekv-army", "leasekv-army", "model_leasekv.cuh",
            "madsim::LeaseKvModel<false, false, true, 1>", (5, 6, 2, 0, 6, 18, (0, 1, 2), 0),
            (48,), _LEASE_WORDS, _LEASE_ARMY, lat=1,
        ),
        KernelModel(
            "leasekv-record-nochaos", "leasekv-record", "model_leasekv.cuh",
            "madsim::LeaseKvModel<true, false, false, 1, false>",
            (5, 6, 2, 0, 6, 15, (), 3), (48,), (*_LEASE_WORDS, "ka_stop_ms"),
            _LEASE_NOCHAOS,
        ),
        KernelModel(
            "shardkv-record-army-nochaos", "shardkv-record-army", "model_shardkv.cuh",
            "madsim::ShardKvModel<true, false, false, true, 1>",
            (14, 17, 3, 0, 6, 18, (), 1), (96,), _SHARD_WORDS, _SHARD_ARMY, lat=1,
        ),
        # the causal soak's libraries (tools/causal_soak.py): kvchaos-bug
        # without its own chaos with the duplication rows (the Duplicate
        # and GrayFailure plan of its exact-arrow certificate), and the
        # 16-write diskless raftlog-record of its cone hunt. That one's
        # pool rows carry 16 payload words, some 21 KB of shared memory a
        # seed with the causal tail, so a block holds 4 seeds of 32 lanes
        KernelModel(
            "kvchaos-bug-nochaos-dup", "kvchaos-bug", "model_kvchaos.cuh",
            "madsim::KvChaosModel<false, true, true, false>", _KV_NOCHAOS_SHAPE,
            (192,), _KV_WORDS, (*_KV_NOCHAOS, ("record", True), ("bug", True)),
            dup=True, obs_pools=(192,),
        ),
        KernelModel(
            "raftlog-record-w16-nochaos", "raftlog-record", "model_raftlog.cuh",
            "madsim::RaftLogModel<true, false, false, false, false, false, 16>",
            _RAFTLOG_W16_SHAPE, (192,), _RAFTLOG_WORDS, _RAFTLOG_W16, group=32,
            obs_pools=(192,),
        ),
        # the retry soak's libraries: every army library runs the retry
        # timers (they compile into each trait with latency markers);
        # these two carry the soak's kvchaos shape and its noidem hunt
        KernelModel(
            "kvchaos-record-army-r2-nochaos", "kvchaos-record-army", "model_kvchaos.cuh",
            "madsim::KvChaosModel<false, true, false, false, true, 2, 1>",
            (4, 4, 2, 0, 6, 15, (), 3), (96,), _KV_WORDS, _KV_ARMY_RETRY, lat=1,
        ),
        KernelModel(
            "shardkv-noidem-army-nochaos", "shardkv-noidem-army", "model_shardkv.cuh",
            "madsim::ShardKvModel<true, false, false, true, 1, true>",
            (14, 17, 3, 0, 6, 18, (), 1), (96,), _SHARD_WORDS, _SHARD_NOIDEM, lat=1,
            obs_pools=(96,),
        ),
        # the explore soak's diskless-raftlog hunt (tools/explore_soak.py):
        # raftlog-record without its own chaos or a disk, driven by the
        # hunt's crash storm and flapping partition with coverage on
        KernelModel(
            "raftlog-record-nochaos", "raftlog-record", "model_raftlog.cuh",
            "madsim::RaftLogModel<true, false>", _RAFTLOG_STORE_SHAPE, (128,),
            _RAFTLOG_WORDS, _RAFTLOG_NOCHAOS, obs_pools=(128,),
        ),
    )
}

# the fields the kernel reads (and, but for seed, writes), in the
# pointer order of Fields (csrc/engine_step.cuh); ev_pay is read and
# written only when the workload has payload words, the history
# columns only when it records, the storage columns only under the sync
# discipline and met only with metrics
HISTORY_COLUMNS = ("hist_count", "hist_drop", "hist_word", "hist_t")
# the ring's columns, with the pool's emit-time sidecar
RING_FIELDS = (*TIMELINE_FIELDS, "ev_emit")
KERNEL_FIELDS = (
    "seed", "now", "step", "halted", "halt_time", "trace", "overflow",
    "msg_count", "ev_time", "ev_valid", "ev_meta", "ev_epoch", "ev_args",
    "ev_pay", "alive", "paused", "epoch", "node_state", "clog", "slow",
    "skew", "dup", *HISTORY_COLUMNS, *STORAGE_FIELDS, "met", *COVERAGE_FIELDS,
    *RING_FIELDS, *LATENCY_FIELDS, *CAUSAL_STATE_FIELDS, *RETRY_STATE_FIELDS,
)
# the taps' columns (the causal ones ride that kernel too), then the
# latency tap's; a launch without the taps kernel passes null for the
# first, one without a latency fold for the second, and check_state
# skips them: the kernel never reads them
OBS_KERNEL_FIELDS = (*COVERAGE_FIELDS, *RING_FIELDS, *CAUSAL_STATE_FIELDS)
READ_ONLY_FIELDS = ("seed",)
# the run's outputs that are its inputs' tensors: never written
SHARED_FIELDS = READ_ONLY_FIELDS
_DTYPES = {
    "seed": torch.int64, "now": torch.int64, "step": torch.int64,
    "halted": torch.bool, "halt_time": torch.int64, "trace": torch.int64,
    "overflow": torch.int32, "msg_count": torch.int64,
    "ev_time": torch.int64, "ev_valid": torch.bool, "ev_meta": torch.int64,
    "ev_epoch": torch.int32, "ev_args": torch.int32, "ev_pay": torch.int32,
    "alive": torch.bool, "paused": torch.bool, "epoch": torch.int32,
    "node_state": torch.int32, "clog": torch.bool, "slow": torch.int32,
    "dup": torch.bool, "skew": torch.int32, "hist_count": torch.int32,
    "hist_drop": torch.int32, "hist_word": torch.int32, "hist_t": torch.int64,
    "disk": torch.int32, "wmask": torch.bool, "sync_loss": torch.bool,
    "sync_eio": torch.bool, "torn": torch.bool, "met": torch.int32,
    "cov": torch.int64, "cov_last": torch.int32, "cov_hits": torch.uint8,
    "tl_count": torch.int32, "tl_drop": torch.int32, "tl_t": torch.int64,
    "tl_meta": torch.int64, "tl_args": torch.int32, "tl_pay": torch.int32,
    "ev_emit": torch.int64, "tl_emit": torch.int64, "lat_inv": torch.int64,
    "lat_resp": torch.int64, "lat_hist": torch.int32, "lat_count": torch.int32,
    "lat_drop": torch.int32, "lam": torch.int64, "ev_parent": torch.int32,
    "ev_lam": torch.int64, "tl_seq": torch.int32, "tl_parent": torch.int32,
    "tl_lam": torch.int64, "rt_done": torch.bool, "rt_attempt": torch.int32,
    "rt_deadline": torch.int64,
}


def workload_shape(wl: Workload) -> tuple:
    """What a model's library is compiled for: ``(n_nodes,
    state_width, args_words, payload_words, max_emits, handlers,
    draw_purposes, history records a call)``."""
    return (
        wl.n_nodes, wl.state_width, wl.args_words, wl.payload_words,
        wl.max_emits, len(wl.handlers),
        tuple(int(p) for p in wl.draw_purposes or ()),
        wl.history.max_records if wl.history is not None else 0,
    )


def kernel_model(wl: Workload, dup_rows: bool = False) -> KernelModel:
    """The registered library that carries ``wl`` (built with the
    duplication rows when ``dup_rows``); raise ``NotImplementedError``
    for any other name, shape, variant or build."""
    cands = [m for m in MODELS.values() if m.name == wl.name]
    if not cands:
        raise NotImplementedError(
            f"the fused run kernel carries no model {wl.name!r}; its libraries "
            f"are {sorted(MODELS)} (another workload needs a model trait in "
            f"csrc/ and an entry in MODELS: ROADMAP queue B1)"
        )
    shape = workload_shape(wl)
    params = dict(wl.model_params)

    def carries(spec):
        fixed = {k: params.get(k) for k, _v in spec.fixed}
        return (shape == spec.shape and fixed == dict(spec.fixed)
                and spec.sync == wl.durable_sync and spec.lat == wl.lat_markers)

    fits = [m for m in cands if carries(m)]
    for spec in fits:
        if spec.dup == bool(dup_rows):
            return spec
    built = ", ".join(
        f"{m.key} ({dict(m.fixed)}{', dup_rows' if m.dup else ''})" for m in cands)
    if fits:
        raise NotImplementedError(
            f"no library of {wl.name!r} at this variant is built "
            f"{'with' if dup_rows else 'without'} the duplication rows "
            f"(dup_rows={bool(dup_rows)}); built: {built}; the others are "
            f"ROADMAP queue B1"
        )
    raise NotImplementedError(
        f"the fused run kernel is compiled for {wl.name!r} as {built}; got "
        f"shape {shape} with {params}: other variants are ROADMAP queue B1"
    )


def config_words(wl: Workload, cfg: EngineConfig) -> tuple:
    """The kernel's config words but the observability widths: the
    engine's 9 (``engine_config`` in csrc/engine_step.cuh, the history
    capacity last), then the model's runtime words. :func:`kernel_args`
    puts the state's three widths (:func:`obs_words`) between them."""
    spec = kernel_model(wl)
    p = dict(wl.model_params)
    return (
        cfg.lat_min_ns, cfg.lat_max_ns, cfg.loss_u32, cfg.proc_min_ns,
        cfg.proc_max_ns, cfg.clog_backoff_min_ns, cfg.clog_backoff_max_ns,
        cfg.time_limit_ns, _history_capacity(wl),
        *(NO_WORD if p[w] is None else int(p[w]) for w in spec.words),
    )


def _history_capacity(wl: Workload) -> int:
    return wl.history.capacity if wl.history is not None else 0


def source_digest(spec: KernelModel) -> str:
    h = hashlib.sha256()
    for name in (*ENGINE_SOURCES, spec.header):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(spec.unit_source().encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the run kernel is built with the CUDA toolkit")


def _paths(spec: KernelModel) -> tuple:
    out_dir = BUILD_ROOT / source_digest(spec)
    return out_dir, out_dir / f"libmadsim_{spec.key}.so", out_dir / "build.log"


def build_libraries(specs=None) -> dict:
    """Build each model's kernel library that this source hash has not
    built yet, one nvcc process per model, all started together.

    Returns ``{key: (path, log)}``; ``log`` is nvcc's output, with the
    ``--resource-usage`` lines (registers, stack frame per thread)."""
    specs = MODELS.values() if specs is None else specs
    out, running = {}, []
    for spec in specs:
        out_dir, lib, log_path = _paths(spec)
        if lib.exists():
            out[spec.key] = (lib, log_path.read_text() if log_path.exists() else "")
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        unit = out_dir / f"{spec.key}.cu"
        unit.write_text(spec.unit_source())
        tmp = out_dir / f"libmadsim_{spec.key}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp), str(unit)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((spec, cmd, proc, tmp, time.perf_counter()))  # lint: allow(wall-clock)
    failed = []
    for spec, cmd, proc, tmp, t0 in running:
        text, _ = proc.communicate()
        _out_dir, lib, log_path = _paths(spec)
        # lint: allow(wall-clock)
        log = f"$ {' '.join(cmd)}\n{text}# {time.perf_counter() - t0:.1f} s\n"
        if proc.returncode != 0:
            failed.append(f"[{spec.key}]\n{log}")
            continue
        log_path.write_text(log)
        os.replace(tmp, lib)
        out[spec.key] = (lib, log)
    if failed:
        raise RuntimeError("nvcc failed building the run kernel:\n" + "\n".join(failed))
    return out


def kernel_registers(build_log: str, pool: int, taps: bool = False) -> dict:
    """The registers nvcc reports (``--resource-usage``) for a library's
    kernels at ``pool``: ``{kernel: registers}`` for the run kernel with
    and without metrics and the drain kernel, without the taps; with
    ``taps``, the taps kernel (``run_kernel<E, MET, true>``) with and
    without metrics instead."""
    out, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for \S*?((?:run|drain)_kernel\S*)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            short = re.match(r"(run|drain)_kernelILi(\d+)E(?:Lb(\d)ELb(\d)E)?", fn)
            if short and int(short.group(2)) == pool and (short.group(4) == "1") == taps:
                name = (f"run(metrics={short.group(3) == '1'})" if short.group(1) == "run"
                        else "drain")
                out[name] = int(m.group(1))
            fn = None
    return out


def build_library(spec: KernelModel) -> tuple[Path, str]:
    """Build (or find) one model's library: ``(path, log)``."""
    return build_libraries([spec])[spec.key]


class RunKernel:
    """The loaded kernel libraries and their launch counts.

    ``counts`` holds the launches per kernel: the run kernel's under the
    model key, the drain kernel's under ``<key>/drain``. A CPU state
    that takes the plain step counts nothing."""

    def __init__(self):
        self.counts: dict = {}
        self._libs: dict = {}

    def reset(self) -> None:
        self.counts = {}

    def _count(self, name: str) -> None:
        self.counts[name] = self.counts.get(name, 0) + 1

    def is_loaded(self, spec: KernelModel) -> bool:
        return spec.key in self._libs

    def load(self, spec: KernelModel):
        lib = self._libs.get(spec.key)
        if lib is None:
            path, _log = build_library(spec)
            lib = ctypes.CDLL(str(path))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.madsim_run.restype = ctypes.c_int
            lib.madsim_run.argtypes = [
                ctypes.POINTER(ptr), ctypes.POINTER(i64), i64, i64, i32, i32,
                i32, i32, i32, ptr,
            ]
            lib.madsim_drain.restype = ctypes.c_int
            lib.madsim_drain.argtypes = [ctypes.POINTER(ptr), i64, i32, i32, ptr]
            lib.madsim_occupancy.restype = ctypes.c_int
            lib.madsim_occupancy.argtypes = [i32, i32, ctypes.POINTER(i64)]
            lib.madsim_shape.restype = None
            lib.madsim_shape.argtypes = [ctypes.POINTER(i64)]
            got = (i64 * 13)()
            lib.madsim_shape(got)
            want = (*spec.shape[:6], spec.shape[7], 2 * len(KERNEL_FIELDS) + 4,
                    len(DRAIN_FIELDS) + 2, spec.shape[4] if spec.dup else 0,
                    int(spec.sync), len(spec.obs_pools), spec.lat)
            if tuple(got) != want:
                raise RuntimeError(
                    f"library {path} is built for (N, U, A, W, K, H, R, run "
                    f"and drain pointers, shadow rows, sync, obs pools, latency "
                    f"markers) = {tuple(got)}; model {spec.key!r} needs {want}"
                )
            self._libs[spec.key] = lib
        return lib

    def launch(self, spec: KernelModel, state: SimState, out: SimState, tables,
               iters, tmax, cfg_words, budget: int, stop_at_halt: bool,
               latency=None, retry=None) -> None:
        """The run kernel: ``budget`` steps of every seed of ``state``
        into ``out``; each seed's count into ``iters`` and their
        maximum into ``tmax``; a state with the counter row runs the
        instantiation that folds the fleet counters into ``out.met``,
        one with latency columns folds the markers under ``latency``
        (its ``LatencySpec``) and one with retry columns runs the timers
        of ``retry`` (its ``RetrySpec``)."""
        lib = self.load(spec)
        if state.seed.shape[0] == 0:
            return
        ptrs, cfg = kernel_args(state, out, tables, iters, tmax, cfg_words, latency,
                                spec.lat > 0, retry)
        rc = lib.madsim_run(
            ptrs, cfg, state.seed.shape[0], int(budget), state.ev_valid.shape[1],
            int(stop_at_halt), int(has_metrics(state)), int(has_obs(state)),
            state.device.index or 0, torch.cuda.current_stream(state.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"run kernel launch for {spec.key!r} failed: error {rc}")
        self._count(spec.key)

    def drain(self, spec: KernelModel, out: SimState, iters, tmax) -> None:
        """The drain kernel, in place on ``out``: each seed takes its
        ``tmax - iters`` remaining halted steps. A CPU state takes the
        plain version, :func:`drain_plain`."""
        if out.device.type == "cpu":
            step, valid = drain_plain(out.step, out.ev_valid, out.ev_time, tmax - iters)
            out.step.copy_(step)
            out.ev_valid.copy_(valid)
            return
        lib = self.load(spec)
        if out.seed.shape[0] == 0:
            return
        tensors = [getattr(out, f) for f in DRAIN_FIELDS] + [iters, tmax]
        ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
        rc = lib.madsim_drain(
            ptrs, out.seed.shape[0], out.ev_valid.shape[1], out.device.index or 0,
            torch.cuda.current_stream(out.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"drain kernel launch for {spec.key!r} failed: error {rc}")
        self._count(f"{spec.key}/drain")

    def occupancy(self, spec: KernelModel, pool: int, device=0) -> dict:
        """The launch shape of ``spec``'s kernels at ``pool``, from the
        card's occupancy calculator: the run kernel, the drain kernel
        and the run kernel with metrics."""
        out = (ctypes.c_int64 * 8)()
        rc = self.load(spec).madsim_occupancy(int(pool), int(device), out)
        if rc != 0:
            raise RuntimeError(f"occupancy query for {spec.key!r} failed: error {rc}")
        keys = ("group", "seeds_per_block", "run_smem_bytes", "run_blocks_per_sm",
                "drain_smem_bytes", "drain_blocks_per_sm", "met_smem_bytes",
                "met_blocks_per_sm")
        return dict(zip(keys, tuple(out)))


KERNEL = RunKernel()
# the fields the drain kernel reads (ev_time) and writes (step, ev_valid)
DRAIN_FIELDS = ("step", "ev_valid", "ev_time")


# the engine's config words in front of the observability widths; the
# latency tap's three words, the causal word and the retry words follow
# those
ENGINE_WORDS = 9
# the retry words: n_ops (0: off), kind, node, op_base, max_attempts,
# timeout_ns, then the backoff and jitter tables of RETRY_ATTEMPT_MAX + 1
# entries each (indexed by the next attempt id, zero past max_attempts)
RETRY_WORDS = 6 + 2 * (RETRY_ATTEMPT_MAX + 1)


def obs_words(state: SimState) -> tuple:
    """The config words 9-11 of a run of ``state``: its coverage words,
    hit-count flag and ring capacity (``core.obs_widths``)."""
    cw, hc, tc = obs_widths(state)
    return (cw, int(hc), tc)


def lat_words(state: SimState, latency, markers: bool = True) -> tuple:
    """The config words 12-14 of a run of ``state``: its latency ops and
    windows and the window width of ``latency``, the run's
    ``LatencySpec``; zeros when the tap is off or the library has no
    markers to fold."""
    c, p = lat_widths(state)
    if not (c and markers):
        return (0, 0, 0)
    if latency is None:
        raise ValueError(
            "a state with latency columns runs with its LatencySpec: pass latency="
        )
    return (c, p, latency.phase_ns)


def retry_words(state: SimState, retry, markers: bool = True) -> tuple:
    """The config words 16 and up of a run of ``state`` (``RETRY_WORDS``
    of them): its policy ``retry`` (a ``RetrySpec`` of the state's retry
    width) as the kernel reads it; zeros when the state has no retry
    columns or the library folds no markers."""
    if not (retry_width(state) and markers):
        return (0,) * RETRY_WORDS
    check_retry_state(state, retry)
    boff, bjit = _retry_backoff_tables(retry)
    pad = (0,) * (RETRY_ATTEMPT_MAX + 1 - len(boff))
    return (retry.n_ops, retry.kind, retry.node, retry.op_base, retry.max_attempts,
            retry.timeout_ns, *boff, *pad, *bjit, *pad)


def kernel_args(state: SimState, out: SimState, tables, iters, tmax, cfg_words,
                latency=None, markers: bool = True, retry=None):
    """The ctypes pointer array and config words of one run launch: the
    input fields, the output fields (null where the kernel writes
    none), the tables, ``iters`` and ``tmax``; ``cfg_words``
    (:func:`config_words`) with the state's observability widths, the
    latency tap's words (:func:`lat_words`, ``markers``: the library
    folds latency markers), the causal word (config word 15: the state
    carries the causal columns) and the retry words (:func:`retry_words`)
    after the engine's words. The caller keeps every tensor alive until
    the launch has run."""
    lw = lat_words(state, latency, markers)
    rw = retry_words(state, retry, markers)
    skip = set()
    if not has_obs(state):
        skip.update(OBS_KERNEL_FIELDS)
    if not lw[0]:
        skip.update(LATENCY_FIELDS)
    if not rw[0]:
        skip.update(RETRY_STATE_FIELDS)
    unwritten = {*READ_ONLY_FIELDS, *_unwritten(state, markers)}
    ins = [0 if f in skip else getattr(state, f).data_ptr() for f in KERNEL_FIELDS]
    outs = [0 if f in skip or f in unwritten else getattr(out, f).data_ptr()
            for f in KERNEL_FIELDS]
    rest = [t.data_ptr() for t in (*tables, iters)]
    rest.append(0 if tmax is None else tmax.data_ptr())
    ptrs = (ctypes.c_void_p * (len(KERNEL_FIELDS) * 2 + 4))(*ins, *outs, *rest)
    # missing engine words (a model without histories may leave out
    # the capacity) are zero
    engine = (*cfg_words[:ENGINE_WORDS], *(0,) * (ENGINE_WORDS - len(cfg_words)))
    words = (*engine, *obs_words(state), *lw, int(causal_on(state)), *rw,
             *cfg_words[ENGINE_WORDS:])
    cfg = (ctypes.c_int64 * len(words))(*words)
    return ptrs, cfg


def check_state(spec: KernelModel, wl: Workload, state: SimState) -> None:
    """Raise unless every field is a contiguous CUDA tensor of the
    port's dtype and of the workload's shape, with a pool size the
    model's kernel was compiled for; only a record library takes a
    state with history rows, only a sync library one with storage rows;
    ``met`` has no slot or all ``N_METRICS``; with a coverage, ring or
    causal column, the taps' columns are those of ``make_init`` at the
    state's widths (without, the kernel never reads them)."""
    dev = state.device
    s, e = state.ev_valid.shape
    if e not in spec.pools:
        raise ValueError(
            f"pool_size={e} has no {spec.key} kernel instantiation; "
            f"supported: {spec.pools}"
        )
    if has_obs(state) and e not in spec.obs_pools:
        built = {m.key: m.obs_pools for m in MODELS.values() if m.obs_pools}
        raise NotImplementedError(
            f"library {spec.key!r} has no kernel with the coverage taps, the "
            f"timeline ring and the causal columns at pool_size={e}; built: "
            f"{built}; the others are ROADMAP queue B1"
        )
    hcap = _history_capacity(wl)
    if (spec.shape[7] > 0) != (hcap > 0):
        raise NotImplementedError(
            f"library {spec.key!r} records {spec.shape[7]} history rows a "
            f"call; workload {wl.name!r} has history capacity {hcap}"
        )
    n, u = wl.n_nodes, wl.state_width
    d = n if wl.durable_sync else 0
    cw, hc, tc = obs_widths(state)
    lc, lp = lat_widths(state)
    ca = causal_on(state)
    cr = retry_width(state)
    if cr and not spec.lat:
        raise NotImplementedError(
            f"library {spec.key!r} folds no latency markers, so it runs no "
            f"client-retry timers; a state with retry columns needs an army library"
        )
    if cw & (cw - 1):
        raise ValueError(f"cov_words={cw} must be 0 (off) or a power of two")
    shapes = dict(
        ev_time=(s, e), ev_valid=(s, e), ev_meta=(s, e), ev_epoch=(s, e),
        ev_args=(s, e, wl.args_words), ev_pay=(s, e, wl.payload_words),
        alive=(s, n), paused=(s, n), epoch=(s, n), skew=(s, n),
        node_state=(s, n, u), clog=(s, n, n), slow=(s, n, n),
        hist_word=(s, hcap, 5), hist_t=(s, hcap),
        disk=(s, d, u), wmask=(s, d, u), sync_loss=(s, d), sync_eio=(s, d), torn=(s, d),
        met=(s, N_METRICS if has_metrics(state) else 0),
        cov=(s, cw), cov_last=(s, n if cw else 0), cov_hits=(s, cw * 32 if hc else 0),
        tl_t=(s, tc), tl_meta=(s, tc), tl_args=(s, tc, wl.args_words),
        tl_pay=(s, tc, wl.payload_words), ev_emit=(s, e if tc else 0), tl_emit=(s, tc),
        lat_inv=(s, lc), lat_resp=(s, lc), lat_hist=(s, lp, N_LAT_BUCKETS if lc else 0),
        lam=(s, n if ca else 0), ev_parent=(s, e if ca else 0), ev_lam=(s, e if ca else 0),
        tl_seq=(s, tc if ca else 0), tl_parent=(s, tc if ca else 0),
        tl_lam=(s, tc if ca else 0),
        rt_done=(s, cr), rt_attempt=(s, cr), rt_deadline=(s, cr),
    )
    skip = set() if has_obs(state) else set(OBS_KERNEL_FIELDS)
    if not (lc and spec.lat):
        skip.update(LATENCY_FIELDS)
    if not (cr and spec.lat):
        skip.update(RETRY_STATE_FIELDS)
    for name in STATE_FIELDS:
        if name in skip:
            continue
        t = getattr(state, name)
        if t.device != dev or t.dtype != _DTYPES[name] or not t.is_contiguous():
            raise ValueError(
                f"field {name!r}: {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ', not contiguous'}; the "
                f"kernel takes contiguous {_DTYPES[name]} on {dev}"
            )
        want = shapes.get(name, (s,))
        if tuple(t.shape) != want:
            raise ValueError(
                f"field {name!r} has shape {tuple(t.shape)}, the workload's "
                f"is {want}"
            )
    if dev.type != "cuda":
        raise ValueError(f"the run kernel needs a CUDA state, got {dev}")


_TABLES: dict = {}


def _tables(wl: Workload, dev) -> tuple:
    """The restart tables as kernel inputs, (N,U) int32 and (U,) uint8,
    copied to ``dev`` once per workload table and device."""
    rows = wl.initial_state()
    vol = wl.volatile_mask().astype("uint8")
    key = (str(torch.device(dev)), rows.shape, rows.tobytes(), vol.tobytes())
    got = _TABLES.get(key)
    if got is None:
        got = _TABLES[key] = (host_to_device(torch.from_numpy(rows), dev),
                              host_to_device(torch.from_numpy(vol), dev))
    return got


def has_obs(state: SimState) -> bool:
    """Whether ``state`` carries a coverage, ring or causal column
    (``make_init`` with ``cov_words``, ``timeline_cap`` or ``causal``): a
    run of it launches the run kernel with the taps."""
    cw, _hc, tc = obs_widths(state)
    return bool(cw or tc or causal_on(state))


def has_metrics(state: SimState) -> bool:
    """Whether ``state`` carries the fleet counters
    (``make_init(metrics=True)``): a run of it launches the run kernel
    that folds them."""
    return state.met.shape[1] == N_METRICS


def _check_metrics(state: SimState, metrics: bool) -> None:
    """Raise unless a CUDA run's ``metrics`` agrees with ``state``'s
    counter row, which picks the kernel."""
    if has_metrics(state) != metrics:
        raise ValueError(
            f"a run with metrics={metrics} needs a state from "
            f"make_init(metrics={metrics}); this one has {state.met.shape[1]} "
            f"metric slots"
        )


def _unwritten(state: SimState, markers: bool = True) -> tuple:
    """The columns a run of ``state`` leaves as they are: the history
    columns when the state has no history rows (a workload that records
    nothing), the storage columns without the sync discipline, ``met``
    without metrics, the coverage or ring columns with their tap off,
    the latency columns with the tap off or on a library without
    ``markers`` (nothing marks an op), the causal columns with the axis
    off and the retry columns without a policy."""
    cw, _hc, tc = obs_widths(state)
    return (
        (HISTORY_COLUMNS if state.hist_word.shape[1] == 0 else ())
        + (STORAGE_FIELDS if state.disk.shape[1] == 0 else ())
        + (() if has_metrics(state) else ("met",))
        + (() if cw else COVERAGE_FIELDS)
        + (() if tc else RING_FIELDS)
        + (() if markers and lat_widths(state)[0] else LATENCY_FIELDS)
        + (() if causal_on(state) else CAUSAL_STATE_FIELDS)
        + (() if markers and retry_width(state) else RETRY_STATE_FIELDS)
    )


def fresh_outputs(state: SimState, markers: bool = True) -> SimState:
    """The run kernel's outputs: ``torch.empty`` for every field it
    writes; ``seed``, and the columns a run leaves as they are
    (history, storage, ``met``, the taps off: ``_unwritten``, with
    ``markers`` whether the library folds latency markers), are the
    input's."""
    shared = {*SHARED_FIELDS, *_unwritten(state, markers)}
    return SimState(**{
        f: getattr(state, f) if f in shared else torch.empty_like(getattr(state, f))
        for f in STATE_FIELDS
    })


def _first_pass(wl: Workload, cfg: EngineConfig, state: SimState,
                n_steps: int, stop_at_halt: bool, dup_rows: bool = False, latency=None,
                retry=None):
    """Launch the run kernel once, up to ``n_steps`` steps per seed,
    from ``state`` into fresh outputs, folding latency markers under
    ``latency`` and running the retry timers of ``retry``. Returns the
    model, the outputs, each seed's step count and their maximum (a
    device word)."""
    spec = kernel_model(wl, dup_rows)
    check_state(spec, wl, state)
    dev = state.device
    out = fresh_outputs(state, spec.lat > 0)
    s = state.seed.shape[0]
    iters = torch.empty((s,), dtype=torch.int64, device=dev)
    tmax = torch.empty((1,), dtype=torch.int64, device=dev)
    KERNEL.launch(spec, state, out, _tables(wl, dev), iters, tmax,
                  config_words(wl, cfg), n_steps, stop_at_halt, latency, retry)
    return spec, out, iters, tmax


def drain_plain(step, ev_valid, ev_time, r):
    """The drain kernel's plain version: ``r`` (per seed) steps of a
    halted seed, each clearing the first minimum of ``ev_valid ? ev_time
    : 2^62`` as the plain step pops it. Returns the new ``step`` and
    ``ev_valid``."""
    from .core import _INF_NS, _first_argmin

    ev_valid = ev_valid.clone()
    ar = torch.arange(ev_valid.shape[0], device=ev_valid.device)
    for k in range(int(r.max()) if r.numel() else 0):
        i = _first_argmin(torch.where(ev_valid, ev_time, _INF_NS))
        ev_valid[ar, i] &= ~(r > k)
    return step + r, ev_valid


def check_taps(state: SimState, metrics: bool, cov_words: int = 0,
               cov_hitcount: bool = False, timeline_cap: int = 0, latency=None,
               causal: bool = False, retry=None) -> None:
    """Raise unless a CUDA run's tap and retry arguments agree with
    ``state``'s columns, which pick the kernel's instantiation and
    widths."""
    _check_metrics(state, metrics)
    check_obs_state(state, cov_words, cov_hitcount, timeline_cap)
    check_lat_state(state, latency)
    check_retry_state(state, retry)
    check_causal_state(state, causal, state.alive.shape[1])
    if causal_on(state) and not causal:
        raise ValueError(
            "a run with causal=False needs a state from make_init(causal=False); "
            "this one carries the causal columns, which the kernel would fold"
        )


def make_run_fused(
    wl: Workload, cfg: EngineConfig, n_steps: int, until_halted: bool = False,
    dup_rows: bool = False, metrics: bool = False, cov_words: int = 0,
    timeline_cap: int = 0, cov_hitcount: bool = False, latency=None,
    causal: bool = False, retry=None,
):
    """Build ``run(state) -> SimState``: ``n_steps`` steps (or, with
    ``until_halted``, steps until every seed has halted, at most
    ``n_steps``) in the fused kernel, with the duplication rows when
    ``dup_rows``, the fleet counters when ``metrics``, the coverage
    taps and the timeline ring at the given widths, the tail-latency
    tap under ``latency``, the causal fold when ``causal`` and the
    client-retry timers of ``retry``. A CPU state takes the plain step;
    a CUDA state launches the kernel or raises."""
    obs = dict(cov_words=cov_words, timeline_cap=timeline_cap, cov_hitcount=cov_hitcount,
               latency=latency, causal=causal, retry=retry)
    plain = (
        make_run_while_plain(wl, cfg, n_steps, dup_rows, metrics, **obs) if until_halted
        else make_run_plain(wl, cfg, n_steps, dup_rows, metrics, **obs)
    )

    def run(state: SimState) -> SimState:
        if state.device.type == "cpu":
            return plain(state)
        check_taps(state, metrics, **obs)
        spec, out, iters, tmax = _first_pass(wl, cfg, state, n_steps, until_halted,
                                             dup_rows, latency, retry)
        if until_halted:
            KERNEL.drain(spec, out, iters, tmax)
        return out

    return run


def halt_counts(wl: Workload, cfg: EngineConfig, cap: int, state: SimState,
                dup_rows: bool = False, latency=None, retry=None):
    """Each seed's steps until it halts (at most ``cap``), from one
    stop-at-halt run kernel launch on ``state``: the seed-steps a
    ``make_run_while`` run does real work in."""
    return _first_pass(wl, cfg, state, cap, True, dup_rows, latency, retry)[2]
