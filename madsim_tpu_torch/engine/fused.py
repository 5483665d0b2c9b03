"""The fused run kernel: the whole step loop in one CUDA launch.

Port of ``madsim_tpu/engine/vmem.py:make_run_vmem``, the JAX package's
one Pallas kernel, which runs ``n_steps`` of ``vmap(make_step)`` with
each block of seeds' state resident on chip. On the H100 the kernel is
hand-written CUDA C++ for ``sm_90a``: a block holds 128 / G seeds'
state in shared memory for the whole loop (fewer where they would not
fit, :func:`library_at`), and each seed runs on a group of G lanes
(``GROUP``). The engine step is generic (``csrc/engine_step.cuh``,
``csrc/lanes.cuh``); each model family is a trait with its handlers as
device code (``csrc/model_*.cuh``), templated on the factory parameters
that set its shape and variant. :data:`FAMILIES` derives, from any
factory workload's name and ``model_params``, the trait's template
arguments, its runtime words, its fixed parameters and the shape it
compiles to (:func:`derive_model`); :data:`MODELS` names, by key and factory call,
the libraries that ``chip_smoke.py`` prebuilds at their pools and the
tests address by key, each built from its derivation, and
:func:`kernel_model` returns a registered entry where one fits, else the
derived library. One key names one translation unit. As the TPU kernel does, the run kernel carries every
factory variant at every pool: the launch instantiates the state's pool
(and taps) where the library has no build for it. A workload whose
family has no trait in ``csrc/`` raises ``NotImplementedError`` on a
CUDA state, naming ``make_run_plain``, the explicit way to run the eager
step there; so does a pool where one seed's state cannot fit a block's
shared memory.

Each library is built with nvcc on first use into
``build/kernels/<hash>/`` at the root of the checkout (keyed by a hash
of the sources, the generated unit and the flags) and loaded with
ctypes; a build or launch failure raises. A CPU state runs the plain
eager step instead (``core.make_run_plain``); a CUDA state never does.

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
the run kernel, built into a registered library only at its
``obs_pools`` (the libraries and pools that ``chip_smoke.py`` and the
card tests drive with them), so every other kernel is compiled as
before; a state with a coverage or ring column (``has_obs``) launches
it, and at any other library or pool the launch builds the library at
that pool with it. Its widths are
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
has a column per node, ``core.causal_on``) launches the taps kernel.
The kernel keeps
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
ones without. A retry state on a library without markers raises; it
never runs the plain step.

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
    "FAMILIES",
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
    "derive_model",
    "drain_plain",
    "fresh_outputs",
    "config_words",
    "halt_counts",
    "kernel_args",
    "kernel_model",
    "library_at",
    "library_for",
    "check_taps",
    "has_obs",
    "make_run_fused",
    "obs_words",
    "seed_bytes",
    "state_taps",
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
# threads a block (MADSIM_THREADS in csrc/run_kernel.cu): 128 / G seeds,
# unless a library's seeds are too large for that many (library_at)
THREADS = 128
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
    ``fixed`` are ``model_params`` the library is compiled for;
    ``threads`` is the block's (``MADSIM_THREADS``)."""

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
    threads: int = THREADS  # threads a block: threads / group seeds

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
            + (f"#define MADSIM_THREADS {self.threads}\n" if self.threads != THREADS else "")
            + '#include "run_kernel.cu"\n'
        )


# Each family's libraries are derived from its workloads: FAMILIES gives,
# for every model family with a trait in csrc/, its header and how a
# workload's name and model_params set the trait's template arguments,
# its runtime words, its fixed parameters and the shape the trait
# compiles to. kernel_model() derives the library of any factory variant
# through it; MODELS (below FAMILIES) names the libraries chip_smoke.py
# prebuilds and the tests address by key.
_KV_WORDS = ("writes", "retx_ns", "client_retx_ns")
_LEASE_WORDS = ("puts", "ttl_ms", "ka_ms", "scan_ms", "put_ms")
_SHARD_WORDS = ("writes", "n_migs", "put_ms", "mig_ms", "retx_ms")
_RAFTLOG_WORDS = ("timeout_min_ns", "timeout_max_ns", "propose_ns", "retx_ns")
_TWOPHASE_WORDS = ("txns", "no_pct", "retx_ns", "revive_min_ns", "revive_max_ns")
_PAXOS_WORDS = ("start_min_ns", "start_max_ns", "timeout_min_ns",
                "timeout_max_ns", "kill_min_ns", "kill_max_ns",
                "revive_min_ns", "revive_max_ns")
# a runtime word whose parameter is None: past any clock a trait compares
# it with
NO_WORD = (1 << 63) - 1


def _kv(nr=4, chaos=True, payload=False, record=False, bug=False, army=False, probes=1):
    return (("n_replicas", nr), ("chaos", chaos), ("payload", payload), ("record", record),
            ("bug", bug), ("army", army), ("army_probes", probes))


def _raftlog(chaos=True, durable=False, bug=None, spread=False, army=False, w=4, n=5):
    return (("n_nodes", n), ("n_writes", w), ("chaos", chaos), ("durable", durable),
            ("bug", bug), ("cov_spread", spread), ("army", army))


def _lease(chaos=True, record=False, bug=False, army=False, probes=1, c=3):
    return (("n_clients", c), ("chaos", chaos), ("record", record), ("bug", bug),
            ("army", army), ("army_probes", probes))


def _shard(chaos=True, record=False, bug=False, army=False, probes=1, g=4, gs=3, ns=8):
    return (("n_groups", g), ("group_size", gs), ("n_shards", ns), ("chaos", chaos),
            ("record", record), ("bug", bug), ("army", army), ("army_probes", probes))


def _targs(trait: str, args: tuple, alias: str | None = None) -> str:
    """``madsim::<trait><...>`` with the template arguments ``args``
    (``(value, default)`` pairs, default None where the trait has none)
    in C++, the trailing ones at their defaults left out but the first;
    ``alias`` names the instantiation whose arguments are all defaults,
    where the header has one."""
    vals = list(args)
    while vals and vals[-1][1] is not None and vals[-1][0] == vals[-1][1]:
        vals.pop()
    if not vals and alias is not None:
        return f"madsim::{alias}"
    vals = vals or list(args[:1])
    text = ", ".join(str(v).lower() if isinstance(v, bool) else str(int(v)) for v, _d in vals)
    return f"madsim::{trait}<{text}>"


def _tokens(*pairs) -> tuple:
    """The key's tokens: each ``(token, on)`` whose ``on`` holds."""
    return tuple(t for t, on in pairs if on)


def _family_raft(wl, p, rec):
    n = p["n_nodes"]
    return dict(
        cxx=_targs("RaftModel", ((rec, None), (n, 5))),
        shape=(n, 6, 2, 0, n + 1, 5, 1 if rec else 0),
        words=("timeout_min_ns", "timeout_max_ns"), fixed=(("n_nodes", n),),
        tokens=_tokens((f"n{n}", n != 5)))


def _family_microbench(wl, p, rec):
    return dict(cxx="madsim::MicrobenchModel", shape=(1, 4, 2, 0, 2, 2, 0),
                words=("rounds", "delay_min_ns", "delay_max_ns"), fixed=(), tokens=())


def _family_pingpong(wl, p, rec):
    c = p["n_clients"]
    return dict(cxx=_targs("PingpongModelT", ((c, 2),), "PingpongModel"),
                shape=(1 + c, 4, 2, 0, 2, 4, 0), words=("rounds",),
                fixed=(("n_clients", c),), tokens=_tokens((f"c{c}", c != 2)))


def _family_broadcast(wl, p, rec):
    n, part = p["n_nodes"], bool(p["partition"])
    return dict(cxx=_targs("BroadcastModelT", ((n, 5), (part, True)), "BroadcastModel"),
                shape=(n, 4, 2, 0, max(n + 2, 6), 4, 0), words=("rounds", "retx_ns"),
                fixed=(("n_nodes", n), ("partition", part)),
                tokens=_tokens((f"n{n}", n != 5), ("nopartition", not part)))


def _family_snapshot(wl, p, rec):
    n = p["n_nodes"]
    return dict(cxx=_targs("SnapshotModelT", ((n, 5),), "SnapshotModel"),
                shape=(n, 6, 2, 0, n + 1, 5, 0),
                words=("n_sends", "balance", "amount_max", "send_min_ns", "send_max_ns",
                       "snap_min_ns", "snap_max_ns"),
                fixed=(("n_nodes", n),), tokens=_tokens((f"n{n}", n != 5)))


def _family_kvchaos(wl, p, rec):
    nr, chaos, payload = p["n_replicas"], bool(p["chaos"]), bool(p["payload"])
    bug, army = bool(p["bug"]), bool(p["army"])
    probes = p["army_probes"] if army else 1
    return dict(
        cxx=_targs("KvChaosModel", ((payload, None), (rec, False), (bug, False), (chaos, True),
                                    (army, False), (nr, 4), (probes, 1))),
        shape=(nr + 2, 6 if payload else 4, 2, 2 if payload else 0, max(nr + 2, 6),
               15 if army else 12, 3 if rec else 0),
        words=_KV_WORDS,
        fixed=_kv(nr, chaos, payload, p["record"], p["bug"], army, p["army_probes"]),
        tokens=_tokens(("nochaos", not chaos), (f"r{nr}", nr != 4),
                       (f"pr{probes}", probes != 1)),
        lat=1 if army else 0)


def _family_raftlog(wl, p, rec):
    n, w, chaos, durable = p["n_nodes"], p["n_writes"], bool(p["chaos"]), bool(p["durable"])
    nosync, spread, army = p["bug"] == "nosync", bool(p["cov_spread"]), bool(p["army"])
    return dict(
        cxx=_targs("RaftLogModel", ((rec, False), (chaos, True), (durable, False),
                                    (nosync, False), (spread, False), (army, False),
                                    (w, 4), (n, 5))),
        shape=(n + (1 if army else 0), 8 + w, 4, w, n + 2, 11 if army else 8,
               max(w, 1) if rec else 0),
        words=_RAFTLOG_WORDS,
        fixed=_raftlog(chaos, durable, p["bug"], spread, army, w, n), sync=durable,
        lat=1 if army else 0,
        tokens=_tokens(("nochaos", not chaos), ("durable", durable and not nosync),
                       ("spread", spread), (f"w{w}", w != 4), (f"n{n}", n != 5)))


def _family_twophase(wl, p, rec):
    n, chaos = p["n_parts"], bool(p["chaos"])
    return dict(cxx=_targs("TwoPhaseModel", ((rec, False), (chaos, True), (n, 4))),
                shape=(1 + n, 6, 3, 0, max(2 * n + 1, n + 6, 6), 9, 1 if rec else 0),
                words=_TWOPHASE_WORDS, fixed=(("n_parts", n), ("chaos", chaos)),
                tokens=_tokens(("nochaos", not chaos), (f"p{n}", n != 4)))


def _family_paxos(wl, p, rec):
    na, np_, chaos = p["n_acceptors"], p["n_proposers"], bool(p["chaos"])
    dur = bool(p["durable_acceptors"])
    return dict(
        cxx=_targs("PaxosModel", ((rec, False), (chaos, True), (dur, False), (na, 5),
                                  (np_, 3))),
        shape=(na + np_, 10, 3, 0, max(na + 2, np_ + 1, 3), 8, 1 if rec else 0),
        words=_PAXOS_WORDS,
        fixed=(("n_acceptors", na), ("n_proposers", np_), ("chaos", chaos),
               ("durable_acceptors", dur)),
        tokens=_tokens(("nochaos", not chaos), ("durable", dur), (f"a{na}", na != 5),
                       (f"p{np_}", np_ != 3)))


def _family_leasekv(wl, p, rec):
    c, chaos, army = p["n_clients"], bool(p["chaos"]), bool(p["army"])
    bug = bool(p["bug"])
    probes = p["army_probes"] if army else 1
    # the stall's word: in every library without chaos (None passes
    # NO_WORD), and with chaos where a stall is set
    stall = not chaos or p["ka_stop_ms"] is not None
    return dict(
        cxx=_targs("LeaseKvModel", ((rec, False), (bug, False), (army, False), (probes, 1),
                                    (chaos, True), (c, 3), (stall, not chaos))),
        shape=(c + 2, max(c + 3, 4), 2, 0, max(c + 1, 6), 18 if army else 15,
               max(c, 1) if rec else 0),
        words=(*_LEASE_WORDS, "ka_stop_ms") if stall else _LEASE_WORDS,
        fixed=_lease(chaos, p["record"], p["bug"], army, p["army_probes"], c),
        tokens=_tokens(("nochaos", not chaos), (f"c{c}", c != 3), (f"pr{probes}", probes != 1),
                       ("stall", chaos and stall)),
        lat=1 if army else 0)


def _family_shardkv(wl, p, rec):
    g, gs, ns, chaos = p["n_groups"], p["group_size"], p["n_shards"], bool(p["chaos"])
    army, bug = bool(p["army"]), p["bug"]
    probes = p["army_probes"] if army else 1
    return dict(
        cxx=_targs("ShardKvModel", ((rec, False), (bug is True, False), (chaos, True),
                                    (army, False), (probes, 1), (bug == "noidem", False),
                                    (g, 4), (gs, 3), (ns, 8))),
        shape=(2 + g * gs, max(2 * ns + 1, 8), 3, 0, max(gs + 1, 6), 18 if army else 15,
               1 if rec else 0),
        words=_SHARD_WORDS,
        fixed=_shard(chaos, p["record"], bug, army, p["army_probes"], g, gs, ns),
        tokens=_tokens(("nochaos", not chaos), (f"pr{probes}", probes != 1),
                       (f"g{g}", g != 4), (f"gs{gs}", gs != 3), (f"s{ns}", ns != 8)),
        lat=1 if army else 0)


# family -> (header, the derivation of a workload's library: its trait
# with template arguments, compile-time shape (N, U, A, W, K, H, R),
# runtime words, fixed parameters, key tokens and sync discipline), by
# the workload's name: "raft-election*" is raft, any other the word
# before its first "-"
FAMILIES = {
    "raft": ("model_raft.cuh", _family_raft),
    "microbench": ("model_microbench.cuh", _family_microbench),
    "pingpong": ("model_pingpong.cuh", _family_pingpong),
    "broadcast": ("model_broadcast.cuh", _family_broadcast),
    "snapshot": ("model_snapshot.cuh", _family_snapshot),
    "kvchaos": ("model_kvchaos.cuh", _family_kvchaos),
    "raftlog": ("model_raftlog.cuh", _family_raftlog),
    "twophase": ("model_twophase.cuh", _family_twophase),
    "paxos": ("model_paxos.cuh", _family_paxos),
    "leasekv": ("model_leasekv.cuh", _family_leasekv),
    "shardkv": ("model_shardkv.cuh", _family_shardkv),
}


def family_of(name: str):
    """The model family of a workload name, or None."""
    if name == "raft-election" or name.startswith("raft-election-"):
        return "raft"
    head = name.split("-")[0]
    return head if head in FAMILIES and head != "raft" else None


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


def derive_model(wl: Workload, dup_rows: bool = False) -> KernelModel:
    """The library of ``wl`` derived through :data:`FAMILIES` (built with
    the duplication rows when ``dup_rows``), with no pool: the launch
    instantiates the state's (:func:`library_at`). Raise
    ``NotImplementedError`` for a workload whose family has no trait in
    csrc/, whose ``model_params`` lack the family's, or whose shape is not
    its trait's."""
    fam = family_of(wl.name)
    if fam is None:
        raise NotImplementedError(
            f"the fused run kernel carries no model {wl.name!r}: its families are "
            f"{sorted(FAMILIES)}, each a trait in csrc/ (another workload needs a "
            f"trait and an entry in FAMILIES); run the eager plain step on "
            f"a CUDA state explicitly with make_run_plain or make_run_while_plain"
        )
    header, derive = FAMILIES[fam]
    p = dict(wl.model_params)
    try:
        d = derive(wl, p, wl.history is not None)
    except KeyError as missing:
        raise NotImplementedError(
            f"workload {wl.name!r} has no model_params {missing}: the {fam} trait is "
            f"derived from the factory's parameters (models.make_{fam})"
        ) from None
    got = workload_shape(wl)
    lat, sync = d.get("lat", 0), d.get("sync", False)
    want, have = d["shape"], (*got[:6], got[7])
    if want != have or lat != wl.lat_markers or sync != wl.durable_sync:
        raise NotImplementedError(
            f"the fused run kernel's {fam} trait {d['cxx']} is compiled for {wl.name!r} "
            f"with (N, U, A, W, K, H, R) = {want}, {lat} latency markers and sync "
            f"discipline {sync}; the workload has {have}, {wl.lat_markers} and "
            f"{wl.durable_sync}, with {p}"
        )
    base = "raft" + wl.name[len("raft-election"):] if fam == "raft" else wl.name
    key = "-".join((base, *d["tokens"], *(("dup",) if dup_rows else ())))
    if not re.fullmatch(r"[A-Za-z0-9-]+", key):
        raise NotImplementedError(f"workload name {wl.name!r} makes no library key: {key!r}")
    return KernelModel(key, wl.name, header, d["cxx"], got, (), d["words"], d["fixed"],
                       dup=bool(dup_rows), sync=sync, lat=lat)


# the registered libraries: (key, family, factory kwargs, pools, then
# obs_pools, group and dup where not their defaults); each entry is its
# factory workload's derivation, built at these pools. The factories'
# default and record (and bug) variants at the model's BENCH_SPECS or
# SOAK_SPECS pool (raft also at the pools of the entry shape and the
# tests, raft-record at the nemesis soak's, kvchaos's record variants at
# the JAX package's history-search pool); the chaos=False variants that
# fault plans drive (tools/nemesis_soak.py's certificates, the port's
# plan tests) at the pools of those runs (96: the JAX tests' kv_cfg and
# the soak's paxos and twophase; 192: the soak's kvchaos), two of them
# also with the duplication rows; then the storage, army, causal, retry
# and explore soaks' libraries. A key is the library's own name, not
# always its derived one (kvchaos-record-army has two probes).
_R, _NC = dict(record=True), dict(chaos=False)
_REGISTERED = (
    ("raft", "raft", {}, (40, 64, 128, 256), (40, 64)),
    ("raft-record", "raft", _R, (40, 64)),
    ("microbench", "microbench", {}, (32,)),
    ("pingpong", "pingpong", {}, (32,)),
    ("broadcast", "broadcast", {}, (40,)),
    ("kvchaos", "kvchaos", {}, (40,)),
    ("kvchaos-payload", "kvchaos", dict(payload=True), (40,)),
    ("kvchaos-record", "kvchaos", _R, (40, 192)),
    ("kvchaos-bug", "kvchaos", dict(_R, bug=True), (40, 192)),
    ("raftlog", "raftlog", {}, (64,)),
    ("raftlog-record", "raftlog", _R, (64,)),
    ("snapshot", "snapshot", {}, (96,)),
    ("twophase", "twophase", {}, (64,)),
    ("twophase-record", "twophase", _R, (64,)),
    ("paxos", "paxos", {}, (64,)),
    ("paxos-record", "paxos", _R, (64,)),
    ("leasekv", "leasekv", {}, (48,), (48,)),
    ("leasekv-record", "leasekv", _R, (48,)),
    ("leasekv-bug", "leasekv", dict(_R, bug=True), (48,)),
    ("shardkv", "shardkv", {}, (64,), (64,)),
    ("shardkv-record", "shardkv", _R, (64,)),
    ("shardkv-bug", "shardkv", dict(_R, bug=True), (64,)),
    ("kvchaos-record-nochaos", "kvchaos", dict(_R, **_NC), (96, 192)),
    ("kvchaos-bug-nochaos", "kvchaos", dict(_R, bug=True, **_NC), (96, 192), (192,)),
    ("kvchaos-record-nochaos-dup", "kvchaos", dict(_R, **_NC), (96, 192), (), GROUP, True),
    ("paxos-record-nochaos", "paxos", dict(_R, **_NC), (96,)),
    ("twophase-record-nochaos", "twophase", dict(_R, **_NC), (96,)),
    ("twophase-record-nochaos-dup", "twophase", dict(_R, **_NC), (96,), (), GROUP, True),
    # the storage libraries: raftlog durable=True with its own chaos
    # (the raftlog bench pool and the store soak's), with cov_spread (its
    # coverage features are the trait's: the coverage searches of the
    # card's smoke run), and the store soak's record variants without
    # chaos, correct and nosync
    ("raftlog-durable", "raftlog", dict(durable=True), (64, 128)),
    ("raftlog-durable-spread", "raftlog", dict(durable=True, cov_spread=True), (64,), (64,)),
    ("raftlog-durable-record", "raftlog", dict(_R, durable=True, **_NC), (96, 128)),
    ("raftlog-nosync-record", "raftlog", dict(_R, durable=True, bug="nosync", **_NC), (128,),
     (128,)),
    # the client-army libraries, each with one latency marker a call: the
    # latency soak's kvchaos at pool 160, the step goldens' kvchaos and
    # raftlog army scenarios with the taps, leasekv, and shardkv-record
    # without its own chaos
    ("kvchaos-army-nochaos", "kvchaos",
     dict(n_replicas=2, army=True, army_probes=3, **_NC), (160,), (160,)),
    ("kvchaos-record-army", "kvchaos", dict(_R, army=True, army_probes=2), (72,), (72,)),
    ("raftlog-record-army", "raftlog", dict(_R, army=True), (96,), (96,)),
    ("leasekv-army", "leasekv", dict(army=True), (48,)),
    # leasekv-record without its own chaos, whose client 1 may stall its
    # keepalives (ka_stop_ms a word, None passing NO_WORD): the etcd lease
    # convergence (tests/test_leasekv.py's dual-mode scenario)
    ("leasekv-record-nochaos", "leasekv", dict(_R, **_NC), (48,)),
    ("shardkv-record-army-nochaos", "shardkv", dict(_R, army=True, **_NC), (96,)),
    # the causal soak's (tools/causal_soak.py): kvchaos-bug without chaos
    # with the duplication rows (its exact-arrow certificate), and the
    # 16-write diskless raftlog-record of its cone hunt, whose pool rows
    # carry 16 payload words, some 21 KB a seed with the causal tail, so a
    # block holds 4 seeds of 32 lanes
    ("kvchaos-bug-nochaos-dup", "kvchaos", dict(_R, bug=True, **_NC), (192,), (192,), GROUP,
     True),
    ("raftlog-record-w16-nochaos", "raftlog", dict(_R, n_writes=16, **_NC), (192,), (192,),
     32),
    # the retry soak's (every army library runs the retry timers): its
    # kvchaos shape and its noidem hunt
    ("kvchaos-record-army-r2-nochaos", "kvchaos", dict(_R, n_replicas=2, army=True, **_NC),
     (96,)),
    ("shardkv-noidem-army-nochaos", "shardkv", dict(_R, bug="noidem", army=True, **_NC),
     (96,), (96,)),
    # the explore soak's diskless-raftlog hunt (tools/explore_soak.py),
    # driven by its crash storm and flapping partition with coverage on
    ("raftlog-record-nochaos", "raftlog", dict(_R, **_NC), (128,), (128,)),
)
_MODELS: dict | None = None


def _registry() -> dict:
    """:data:`MODELS`, derived on first use (the factories import the
    engine, so not at import)."""
    global _MODELS
    if _MODELS is None:
        from .. import models

        def entry(key, fam, kw, pools, obs_pools=(), group=GROUP, dup=False):
            wl = getattr(models, f"make_{fam}")(**kw)
            return dataclasses.replace(derive_model(wl, dup), key=key, pools=pools,
                                       obs_pools=obs_pools, group=group)

        _MODELS = {e[0]: entry(*e) for e in _REGISTERED}
    return _MODELS


def __getattr__(name: str):
    if name == "MODELS":
        return _registry()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def kernel_model(wl: Workload, dup_rows: bool = False) -> KernelModel:
    """The library that carries ``wl`` (with the duplication rows when
    ``dup_rows``): the registered :data:`MODELS` entry of its derived
    trait, words and shape where one fits, else the derived library
    (:func:`derive_model`, raising for a workload without a trait). A
    derived key that a registered library of another unit holds gains a
    short hash of its own unit."""
    spec = derive_model(wl, dup_rows)
    registry = _registry()
    for m in registry.values():
        if (m.name == spec.name and m.cxx == spec.cxx and m.dup == spec.dup
                and m.words == spec.words and m.shape == spec.shape):
            return m
    if spec.key in registry:
        unit = hashlib.sha256(spec.unit_source().encode()).hexdigest()[:8]
        spec = dataclasses.replace(spec, key=f"{spec.key}-u{unit}")
    return spec


# a block's opt-in shared memory on the H100 (227 KB), less 1 KB for
# the kernels' static words
SMEM_LIMIT = 227 * 1024 - 1024
# a lane's pool slots fit one 64-bit mask (csrc/lanes.cuh): pool / G <= 64
_MAX_SLOTS_A_LANE = 64


def _align(n: int, a: int) -> int:
    return (n + a - 1) // a * a


def seed_bytes(spec: KernelModel, pool: int, metrics: bool = True) -> int:
    """``sizeof(madsim::Seed<Model, pool, metrics>)`` (csrc/engine_step.cuh),
    the shared bytes of one seed without the taps, from the library's
    compile-time shape: the bases (history counters, storage, counters),
    then the members in declaration order, each at its alignment."""
    n, u, a, w, k, _h, draws, r = spec.shape
    e = pool
    size = (8 if r > 0 else 0) + (_align(5 * n * u + 3 * n, 4) if spec.sync else 0)
    size += 4 * N_METRICS if metrics else 0
    size = _align(size, 8) + 8 * e + 5 * 8
    emit = _align(24 + 4 * a + 4 * max(w, 1), 8)
    size += emit * (k + 1 + (1 if spec.lat > 0 else 0))
    kt = k + 1 + (k if spec.dup else 0)
    words = (2 * e + e * a + (e * w if w else 1) + (e + 31) // 32 + 2 * n + n * u + n * n
             + u + 2 * kt + max(len(draws), 1) + 2)
    size += 4 * words + 2 * n + n * n + 2
    return _align(size, 8)


def obs_bytes(n_nodes: int, pool: int, cov_words: int = 0, cov_hitcount: bool = False,
              timeline_cap: int = 0, causal: bool = False) -> int:
    """The taps' shared tail of one seed (``obs_layout``,
    csrc/engine_step.cuh): 0 with every tap off."""
    b = (8 * pool + 8 if timeline_cap else 0) + (8 * pool + 4 * n_nodes if causal else 0)
    if cov_words:
        b += 4 * cov_words + 4 * n_nodes + (32 * cov_words if cov_hitcount else 0)
    return _align(b, 16)


def seed_stride(spec: KernelModel, pool: int, taps: tuple = (0, False, 0, False)) -> int:
    """The shared bytes a seed takes in the run kernel with metrics under
    ``taps`` (cov_words, hit counts, ring capacity, causal): its Seed, and
    with a tap on the 16-aligned Seed and the tail (``seed_stride``)."""
    sb = seed_bytes(spec, pool)
    ob = obs_bytes(spec.shape[0], pool, *taps)
    return _align(sb, 16) + ob if ob else sb


def library_at(spec: KernelModel, pool: int, taps: tuple = (0, False, 0, False)
               ) -> KernelModel:
    """The library that runs ``spec``'s kernel at ``pool`` under
    ``taps`` (cov_words, hit counts, ring capacity, causal: any on
    launches the taps instantiation): ``spec`` itself where it is built
    at that pool (and taps pool) and its block of ``threads / group``
    seeds fits :data:`SMEM_LIMIT`; otherwise ``spec`` built at that one
    pool (with the taps instantiation only if the run needs it), with
    more lanes a seed where the pool outgrows a lane's 64 slots, and
    with fewer threads a block (whole warps, whole groups) where its
    seeds would not fit. Raise ``NotImplementedError`` where one seed
    cannot fit, naming its bytes."""
    obs = bool(taps[0] or taps[2] or taps[3])
    group = spec.group
    while pool > _MAX_SLOTS_A_LANE * group and group < 32:
        group *= 2
    if pool > _MAX_SLOTS_A_LANE * group:
        raise NotImplementedError(
            f"pool_size={pool} is more than {_MAX_SLOTS_A_LANE} slots for each of a "
            f"seed's 32 lanes: the run kernel takes pools up to "
            f"{_MAX_SLOTS_A_LANE * 32}")
    stride = seed_stride(spec, pool, taps)
    fit = SMEM_LIMIT // stride
    built = pool in spec.pools and (not obs or pool in spec.obs_pools)
    if built and group == spec.group and fit >= spec.threads // spec.group:
        return spec
    if fit < 1:
        raise NotImplementedError(
            f"one seed of {spec.key!r} at pool_size={pool} takes {stride} bytes of "
            f"shared memory (its state and the taps' tail), more than the "
            f"{SMEM_LIMIT} bytes a block may hold: the run kernel keeps a seed's "
            f"whole state on chip, as the TPU kernel keeps a block's in VMEM")
    threads = min(THREADS // group, fit) * group
    if threads >= 32:
        threads -= threads % 32
    key = (f"{spec.key}-p{pool}" + ("-obs" if obs else "")
           + (f"-g{group}" if group != spec.group else "")
           + (f"-t{threads}" if threads != THREADS else ""))
    return dataclasses.replace(spec, key=key, pools=(pool,), obs_pools=(pool,) if obs else (),
                               group=group, threads=threads)


def state_taps(state: SimState) -> tuple:
    """``(cov_words, hit counts, ring capacity, causal)`` of ``state``'s
    columns, the taps a run of it launches with."""
    cw, hc, tc = obs_widths(state)
    return (cw, bool(hc), tc, causal_on(state))


def library_for(wl: Workload, pool: int, dup_rows: bool = False, cov_words: int = 0,
                cov_hitcount: bool = False, timeline_cap: int = 0,
                causal: bool = False) -> KernelModel:
    """The library a run of ``wl`` at ``pool`` with these taps launches:
    :func:`kernel_model`, then :func:`library_at`."""
    return library_at(kernel_model(wl, dup_rows), pool,
                      (cov_words, bool(cov_hitcount), timeline_cap, bool(causal)))


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
    specs = _registry().values() if specs is None else specs
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
        return self._libs.get(spec.key, (None,))[0] == spec.unit_source()

    def load(self, spec: KernelModel):
        """The library of ``spec``, built and loaded on first use; one key
        names one translation unit in a process, else this raises."""
        unit = spec.unit_source()
        held, lib = self._libs.get(spec.key, (None, None))
        if held is not None and held != unit:
            raise RuntimeError(
                f"library key {spec.key!r} is loaded for another translation unit; a key "
                f"names one unit:\n{held}\nnot\n{unit}")
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
            self._libs[spec.key] = (unit, lib)
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
    port's dtype and of the workload's shape (any pool: the launch's
    library instantiates it, :func:`library_at`); only a record library
    takes a state with history rows, only a sync library one with
    storage rows; ``met`` has no slot or all ``N_METRICS``; with a
    coverage, ring or causal column, the taps' columns are those of
    ``make_init`` at the state's widths (without, the kernel never reads
    them)."""
    dev = state.device
    s, e = state.ev_valid.shape
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
    spec = library_at(spec, state.ev_valid.shape[1], state_taps(state))
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
