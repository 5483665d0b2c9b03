"""The run kernel's libraries derived from the workload
(``engine/fused.py`` ``FAMILIES``, ``derive_model``, ``library_at``).

Every registered library (``fused.MODELS``) is built from its factory
workload's derivation and keeps the unit it was registered with; one
library key names one unit. Factory variants off the registry (other
node, client, participant, acceptor, group and shard counts, broadcast
without its partition, paxos with durable acceptors, the leasekv stall
under the model's own chaos, raftlog combinations) derive a library
whose compile-time shape is the workload's; ten of them are built for
the host with g++ (``tests/_torch_host.py``) and held per field against
the plain step, their seeds' shared bytes against ``fused.seed_bytes``,
and so is raft at pool 512 with every tap at 64 threads a block;
four run through the port's plain step against the JAX package's
``make_run_while``. The launch's own choices are checked on the CPU: a
library built at the state's pool, with the taps where the run needs
them, fewer threads a block where its seeds would not fit, and a raise
where one seed cannot fit. Exact equality."""

import dataclasses

import numpy as np
import pytest

import madsim_tpu.models as jm
import madsim_tpu_torch.models as tm
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import fused

from madsim_tpu_torch.engine.convert import state_to_numpy

from _torch_host import assert_host_matches_plain, build_host_kernel, host_run
from _torch_parity import run_both

SEEDS = np.arange(64, dtype=np.uint64) * np.uint64(7919)

# each registered library's trait (in madsim::), pools and taps pools:
# the units chip_smoke.py prebuilds, as they were written out by hand
UNITS = {
    "raft": ("RaftModel<false>", (40, 64, 128, 256), (40, 64)),
    "raft-record": ("RaftModel<true>", (40, 64), ()),
    "microbench": ("MicrobenchModel", (32,), ()),
    "pingpong": ("PingpongModel", (32,), ()),
    "broadcast": ("BroadcastModel", (40,), ()),
    "kvchaos": ("KvChaosModel<false>", (40,), ()),
    "kvchaos-payload": ("KvChaosModel<true>", (40,), ()),
    "kvchaos-record": ("KvChaosModel<false, true>", (40, 192), ()),
    "kvchaos-bug": ("KvChaosModel<false, true, true>", (40, 192), ()),
    "raftlog": ("RaftLogModel<false>", (64,), ()),
    "raftlog-record": ("RaftLogModel<true>", (64,), ()),
    "snapshot": ("SnapshotModel", (96,), ()),
    "twophase": ("TwoPhaseModel<false>", (64,), ()),
    "twophase-record": ("TwoPhaseModel<true>", (64,), ()),
    "paxos": ("PaxosModel<false>", (64,), ()),
    "paxos-record": ("PaxosModel<true>", (64,), ()),
    "leasekv": ("LeaseKvModel<false>", (48,), (48,)),
    "leasekv-record": ("LeaseKvModel<true>", (48,), ()),
    "leasekv-bug": ("LeaseKvModel<true, true>", (48,), ()),
    "shardkv": ("ShardKvModel<false>", (64,), (64,)),
    "shardkv-record": ("ShardKvModel<true>", (64,), ()),
    "shardkv-bug": ("ShardKvModel<true, true>", (64,), ()),
    "kvchaos-record-nochaos": ("KvChaosModel<false, true, false, false>", (96, 192), ()),
    "kvchaos-bug-nochaos": ("KvChaosModel<false, true, true, false>", (96, 192), (192,)),
    "kvchaos-record-nochaos-dup": ("KvChaosModel<false, true, false, false>", (96, 192), ()),
    "paxos-record-nochaos": ("PaxosModel<true, false>", (96,), ()),
    "twophase-record-nochaos": ("TwoPhaseModel<true, false>", (96,), ()),
    "twophase-record-nochaos-dup": ("TwoPhaseModel<true, false>", (96,), ()),
    "raftlog-durable": ("RaftLogModel<false, true, true>", (64, 128), ()),
    "raftlog-durable-spread": ("RaftLogModel<false, true, true, false, true>", (64,), (64,)),
    "raftlog-durable-record": ("RaftLogModel<true, false, true>", (96, 128), ()),
    "raftlog-nosync-record": ("RaftLogModel<true, false, true, true>", (128,), (128,)),
    "kvchaos-army-nochaos": ("KvChaosModel<false, false, false, false, true, 2, 3>", (160,),
                             (160,)),
    "kvchaos-record-army": ("KvChaosModel<false, true, false, true, true, 4, 2>", (72,), (72,)),
    "raftlog-record-army": ("RaftLogModel<true, true, false, false, false, true>", (96,),
                            (96,)),
    "leasekv-army": ("LeaseKvModel<false, false, true>", (48,), ()),
    "leasekv-record-nochaos": ("LeaseKvModel<true, false, false, 1, false>", (48,), ()),
    "shardkv-record-army-nochaos": ("ShardKvModel<true, false, false, true>", (96,), ()),
    "kvchaos-bug-nochaos-dup": ("KvChaosModel<false, true, true, false>", (192,), (192,)),
    "raftlog-record-w16-nochaos": ("RaftLogModel<true, false, false, false, false, false, 16>",
                                   (192,), (192,)),
    "kvchaos-record-army-r2-nochaos": ("KvChaosModel<false, true, false, false, true, 2>", (96,),
                                       ()),
    "shardkv-noidem-army-nochaos": ("ShardKvModel<true, false, false, true, 1, true>", (96,),
                                    (96,)),
    "raftlog-record-nochaos": ("RaftLogModel<true, false>", (128,), (128,)),
}


def factory(family: str, module=tm):
    return getattr(module, f"make_{family}")


# variants off the registry: key -> (family, factory kwargs, engine
# kwargs, make_run_while cap); the first ten are built for the host
VARIANTS = {
    "raft-n3": ("raft", dict(n_nodes=3), dict(pool_size=40, loss_p=0.02), 600),
    "raft-n7": ("raft", dict(n_nodes=7), dict(pool_size=96, loss_p=0.02), 600),
    "broadcast-n4-nopartition": ("broadcast", dict(n_nodes=4, partition=False),
                                 dict(pool_size=40, loss_p=0.05), 500),
    "snapshot-n4": ("snapshot", dict(n_nodes=4), dict(pool_size=96, loss_p=0.02), 2000),
    "pingpong-c3": ("pingpong", dict(n_clients=3), dict(pool_size=32, loss_p=0.02), 500),
    "twophase-p3": ("twophase", dict(n_parts=3), dict(pool_size=64, loss_p=0.02), 1500),
    "paxos-durable-a3": ("paxos", dict(n_acceptors=3, durable_acceptors=True),
                         dict(pool_size=96, loss_p=0.02), 800),
    "leasekv-c5-stall": ("leasekv", dict(n_clients=5, ka_stop_ms=2000),
                         dict(pool_size=48, loss_p=0.02), 1500),
    "shardkv-g3-gs5": ("shardkv", dict(n_groups=3, group_size=5),
                       dict(pool_size=64, loss_p=0.02), 1500),
    "raftlog-n7": ("raftlog", dict(n_nodes=7), dict(pool_size=96, loss_p=0.02), 1500),
    # derived on the card only (chip_smoke.py phase 72)
    "kvchaos-army": ("kvchaos", dict(army=True), dict(pool_size=64), 2000),
    "raftlog-record-durable": ("raftlog", dict(durable=True, record=True),
                               dict(pool_size=64, loss_p=0.02), 1500),
    "raftlog-army": ("raftlog", dict(army=True), dict(pool_size=96), 1500),
    "kvchaos-payload-record": ("kvchaos", dict(payload=True, record=True),
                               dict(pool_size=40), 1500),
    "raftlog-spread": ("raftlog", dict(cov_spread=True), dict(pool_size=64), 1500),
    "paxos-record-nochaos-dup": ("paxos", dict(record=True, chaos=False),
                                 dict(pool_size=96), 800),
}
HOST = tuple(VARIANTS)[:10]


def _variant(key):
    fam, kw, ekw, cap = VARIANTS[key]
    return factory(fam)(**kw), tcore.EngineConfig(**ekw), cap


@pytest.mark.parametrize("key", sorted(UNITS))
def test_each_registered_library_keeps_its_unit(key):
    """Each MODELS entry, built from its factory workload's derivation,
    compiles the trait, pools and taps pools it was registered with, at
    the default block, and kernel_model returns it for that workload."""
    spec = fused.MODELS[key]
    cxx, pools, obs_pools = UNITS[key]
    assert (spec.cxx, spec.pools, spec.obs_pools) == (f"madsim::{cxx}", pools, obs_pools)
    assert spec.group == (32 if key == "raftlog-record-w16-nochaos" else fused.GROUP)
    assert spec.dup == key.endswith("-dup")
    _key, fam, kw, *_rest = next(e for e in fused._REGISTERED if e[0] == key)
    wl = factory(fam)(**kw)
    assert fused.kernel_model(wl, spec.dup) is spec and spec.shape == fused.workload_shape(wl)
    assert spec.threads == fused.THREADS and "MADSIM_THREADS" not in spec.unit_source()


def test_the_registry_has_one_entry_per_trait_and_variant():
    seen = {}
    for key, m in fused.MODELS.items():
        assert seen.setdefault((m.cxx, m.dup, m.words), key) == key
    assert set(UNITS) == set(fused.MODELS)


def test_a_derived_key_never_names_a_registered_library_of_another_unit():
    """Two registered keys are not their derivation's: kvchaos-record-army
    has two probes, kvchaos-army-nochaos two replicas and three probes.
    The factories' defaults derive those keys too, so they gain their
    unit's hash, and at a pool no library has their launched keys
    differ from the registered entries'."""
    for key, kw in (("kvchaos-record-army", dict(record=True, army=True)),
                    ("kvchaos-army-nochaos", dict(army=True, chaos=False))):
        spec = fused.kernel_model(tm.make_kvchaos(**kw))
        reg = fused.MODELS[key]
        assert spec.cxx != reg.cxx and spec.key.startswith(f"{key}-u") and spec.key not in fused.MODELS
        assert fused.kernel_model(tm.make_kvchaos(**kw)) == spec
        mine, theirs = fused.library_at(spec, 64), fused.library_at(reg, 64)
        assert mine.key != theirs.key and theirs.key == f"{key}-p64"


def test_every_derived_key_names_one_unit():
    """Over the factories' switches and some counts, one library key (at
    one pool, with and without the taps) names one translation unit."""
    import itertools

    grid = {
        "raft": dict(record=(False, True), n_nodes=(3, 5, 7)),
        "broadcast": dict(n_nodes=(4, 5), partition=(False, True)),
        "pingpong": dict(n_clients=(2, 3)),
        "snapshot": dict(n_nodes=(4, 5)),
        "kvchaos": dict(payload=(False, True), record=(False, True), bug=(False, True),
                        chaos=(False, True), army=(False, True), army_probes=(1, 2, 3),
                        n_replicas=(2, 4)),
        "raftlog": dict(record=(False, True), chaos=(False, True), durable=(False, True),
                        cov_spread=(False, True), army=(False, True), n_nodes=(5, 7)),
        "twophase": dict(record=(False, True), chaos=(False, True), n_parts=(3, 4)),
        "paxos": dict(record=(False, True), chaos=(False, True),
                      durable_acceptors=(False, True), n_acceptors=(3, 5)),
        "leasekv": dict(record=(False, True), chaos=(False, True), army=(False, True),
                        ka_stop_ms=(None, 2000), n_clients=(3, 5)),
        "shardkv": dict(record=(False, True), chaos=(False, True), army=(False, True),
                        n_groups=(3, 4)),
    }
    units, n = {}, 0
    for fam, axes in grid.items():
        for values in itertools.product(*axes.values()):
            try:
                wl = factory(fam)(**dict(zip(axes, values)))
            except (ValueError, AssertionError):
                continue  # a combination the factory refuses
            for dup in (False, True):
                for taps in ((0, False, 0, False), (8, False, 0, False)):
                    lib = fused.library_at(fused.kernel_model(wl, dup), 96, taps)
                    assert units.setdefault(lib.key, lib.unit_source()) == lib.unit_source(), lib.key
                    n += 1
    assert n > 500


def test_the_loaded_libraries_refuse_one_key_for_two_units():
    """The in-process cache of loaded libraries is keyed by library and
    holds its unit: a second unit under a loaded key raises."""
    kernel = fused.RunKernel()
    spec = fused.library_at(fused.kernel_model(tm.make_raft(n_nodes=3)), 96)
    other = dataclasses.replace(spec, cxx="madsim::RaftModel<false, 4>")
    kernel._libs[spec.key] = (spec.unit_source(), object())
    assert kernel.is_loaded(spec) and not kernel.is_loaded(other)
    with pytest.raises(RuntimeError, match="loaded for another translation unit"):
        kernel.load(other)


@pytest.mark.parametrize("key", sorted(VARIANTS))
def test_a_variant_off_the_registry_derives_its_library(key):
    """Its key is stable, its compile-time shape is the workload's, it
    is no registered entry, and on a CPU state check_state refuses only
    for the device."""
    wl, cfg, _cap = _variant(key)
    spec = fused.kernel_model(wl, dup_rows=key.endswith("-dup"))
    assert spec.key == key and spec.shape == fused.workload_shape(wl)
    assert spec.key not in fused.MODELS and spec.pools == () and spec.obs_pools == ()
    assert fused.kernel_model(wl, dup_rows=key.endswith("-dup")) == spec
    lib = fused.library_at(spec, cfg.pool_size)
    assert lib.key == f"{key}-p{cfg.pool_size}" and lib.pools == (cfg.pool_size,)
    assert f"#define MADSIM_POOLS {cfg.pool_size}\n" in lib.unit_source()
    st = tcore.make_init(wl, cfg, device="cpu")(SEEDS[:2])
    with pytest.raises(ValueError, match="CUDA"):
        fused.check_state(spec, wl, st)


def test_the_launch_builds_a_registered_library_at_another_pool_or_taps():
    raft = tm.make_raft()
    spec = fused.kernel_model(raft)
    assert fused.library_at(spec, 40) is spec and fused.library_at(spec, 64, (2, False, 0, False)) is spec
    at96 = fused.library_at(spec, 96)
    assert (at96.key, at96.pools, at96.obs_pools) == ("raft-p96", (96,), ())
    taps = fused.library_at(spec, 128, (2, False, 0, False))
    assert (taps.key, taps.pools, taps.obs_pools) == ("raft-p128-obs", (128,), (128,))
    assert fused.library_for(raft, 128, cov_words=2) == taps
    # a causal state launches the taps kernel: raft-record has none at 40
    rec = fused.library_for(tm.make_raft(record=True), 40, causal=True)
    assert rec.key == "raft-record-p40-obs" and rec.obs_pools == (40,)
    # past 64 slots a lane, more lanes a seed
    big = fused.library_at(spec, 1024)
    assert big.group == 16 and big.key == "raft-p1024-g16"


def test_a_block_takes_fewer_seeds_where_sixteen_do_not_fit():
    """Raft at pool 512 with every tap: 16 seeds take more than a block's
    shared memory, so the library is built with fewer threads, whole
    warps; a pool where one seed cannot fit raises, naming its bytes."""
    taps = (64, True, 256, True)
    spec = fused.kernel_model(tm.make_raft())
    stride = fused.seed_stride(spec, 512, taps)
    assert 16 * stride > fused.SMEM_LIMIT
    lib = fused.library_at(spec, 512, taps)
    assert lib.threads < fused.THREADS and lib.threads % 32 == 0
    assert (lib.threads // lib.group) * stride <= fused.SMEM_LIMIT
    assert lib.key == f"raft-p512-obs-t{lib.threads}"
    assert f"#define MADSIM_THREADS {lib.threads}\n" in lib.unit_source()
    assert fused.library_at(spec, 512) is not lib and fused.library_at(spec, 512).threads == 128
    wide = fused.kernel_model(tm.make_raftlog(n_writes=16, chaos=False))
    with pytest.raises(NotImplementedError, match=r"takes \d+ bytes of shared memory"):
        fused.library_at(wide, 2048, (0, False, 8, True))


def test_what_still_raises():
    """No trait (a user's own workload), a shape that is not its trait's,
    and params missing from a family's workload."""
    raft = tm.make_raft()
    other = tcore.Workload(name="other", n_nodes=5, state_width=6, handlers=raft.handlers,
                           max_emits=6, args_words=2)
    with pytest.raises(NotImplementedError, match="carries no model 'other'.*make_run_plain"):
        fused.kernel_model(other)
    with pytest.raises(NotImplementedError, match="compiled for 'raft-election'"):
        fused.kernel_model(dataclasses.replace(raft, max_emits=9))
    with pytest.raises(NotImplementedError, match="no model_params"):
        fused.kernel_model(dataclasses.replace(raft, model_params=()))


def test_a_family_registered_outside_csrc_derives_its_library(tmp_path, monkeypatch):
    """A workload of no family (the tests' chaos3) raises; registered in
    FAMILIES, as the card test of the engine kinds registers it, it
    derives its library, built at the state's pool."""
    from _torch_chaos3 import CHAOS_CFG, chaos3_family, chaos3_workload

    wl = chaos3_workload()
    with pytest.raises(NotImplementedError, match="carries no model 'chaos3'.*make_run_plain"):
        fused.kernel_model(wl)
    header, _derive = entry = chaos3_family(tmp_path)
    monkeypatch.setitem(fused.FAMILIES, "chaos3", entry)
    spec = fused.kernel_model(wl)
    assert (spec.key, spec.header, spec.cxx, spec.pools) == ("chaos3", header, "Chaos3Model", ())
    assert spec.shape == fused.workload_shape(wl)
    pool = CHAOS_CFG["pool_size"]
    assert fused.library_for(wl, pool).key == f"chaos3-p{pool}"
    assert fused.kernel_model(wl, dup_rows=True).key == "chaos3-dup"


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The g++ host builds of the first ten variants, each built once, at
    its engine config's pool."""
    built = {}

    def get(key):
        if key not in built:
            wl, cfg, _cap = _variant(key)
            spec = fused.kernel_model(wl)
            built[key] = build_host_kernel(tmp_path_factory.mktemp(key), spec,
                                           (cfg.pool_size,))
        return built[key]

    return get


@pytest.mark.parametrize("key", HOST)
def test_host_built_variant_matches_plain_step(host_libs, key):
    wl, cfg, cap = _variant(key)
    lib = host_libs(key)
    spec = fused.kernel_model(wl)
    for met in (False, True):
        assert lib.host_seed_bytes(cfg.pool_size, int(met)) == fused.seed_bytes(
            spec, cfg.pool_size, met)
    want = assert_host_matches_plain(lib, wl, cfg, SEEDS, cap, True)
    assert want["halted"].any()


def test_host_built_block_of_fewer_threads_matches_plain_step(tmp_path):
    """Raft at pool 512 with every tap (phase 72.9's library): 16 seeds do
    not fit a block, so it is built with 64 threads, 8 seeds of 8 lanes.
    The host build at that MADSIM_THREADS runs 8 seeds a block side by
    side in one buffer, the last block part full, and equals the plain
    step per field."""
    wl, cfg = tm.make_raft(), tcore.EngineConfig(pool_size=512, loss_p=0.02)
    taps = dict(cov_words=64, cov_hitcount=True, timeline_cap=256, causal=True)
    lib = fused.library_for(wl, cfg.pool_size, **taps)
    assert (lib.key, lib.threads, lib.group) == ("raft-p512-obs-t64", 64, 8)
    host = build_host_kernel(tmp_path, lib, (cfg.pool_size,), obs=True, threads=lib.threads)
    st = tcore.make_init(wl, cfg, device="cpu", **taps)(SEEDS[:60])
    want = state_to_numpy(tcore.make_run_while_plain(wl, cfg, 600, **taps)(st))
    got = state_to_numpy(host_run(host, wl, cfg, st, 600, True))
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert want["halted"].any() and want["cov"].any() and want["tl_count"].min() > 0


# four variants through the JAX package's engine: factory kwargs for both
JAX_CASES = ("raft-n7", "broadcast-n4-nopartition", "paxos-durable-a3", "shardkv-g3-gs5")


@pytest.mark.parametrize("key", JAX_CASES)
def test_port_plain_step_matches_jax_at_variant(key):
    fam, kw, ekw, cap = VARIANTS[key]
    t = run_both(factory(fam, jm)(**kw), factory(fam)(**kw), ekw, SEEDS[:8], cap,
                 until_halted=True)
    assert t["halted"].any()
