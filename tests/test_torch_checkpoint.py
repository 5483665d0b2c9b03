"""Checkpoints cross between the port and the JAX package, both ways.

A file the JAX package saves loads into the port, and the port's resume
equals its uninterrupted run; a file the port saves loads into the JAX
package, and the JAX resume equals the JAX uninterrupted run; a
recording workload's history columns travel too (leasekv-record). Each
refusal (another config, int32 event times, a non-empty entry for a
field the port does not carry) raises with its message. Exact equality.
"""

import json

import numpy as np
import pytest

import jax

import madsim_tpu.engine as je
from madsim_tpu.engine.core import POOL_INDEX_STATE_FIELDS
from madsim_tpu.models import make_kvchaos as j_kvchaos
from madsim_tpu.models import make_leasekv as j_leasekv
from madsim_tpu.models import make_raft as j_raft
from madsim_tpu.models import make_shardkv as j_shardkv
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.checkpoint import load, save
from madsim_tpu_torch.models import (
    BENCH_SPECS, SOAK_SPECS, make_kvchaos, make_leasekv, make_raft, make_shardkv,
)

from _torch_parity import assert_same_state, jax_fields

N_SEEDS, SPLIT = 64, 20
# name -> (JAX factory, port factory, engine kwargs)
CASES = {
    "raft": (j_raft, make_raft, BENCH_SPECS["raft"][1]),
    "kvchaos-payload": (lambda: j_kvchaos(payload=True), lambda: make_kvchaos(payload=True),
                        BENCH_SPECS["kvchaos"][1]),
    "leasekv-record": (lambda: j_leasekv(record=True), lambda: make_leasekv(record=True),
                       SOAK_SPECS["leasekv"][1]),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One JAX compile per model: ``SPLIT`` steps of ``make_run``."""
    jf, tf, kw = CASES[request.param]
    jwl, jcfg = jf(), je.EngineConfig(**kw)
    jrun = jax.jit(je.make_run(jwl, jcfg, SPLIT, layout="scatter", time32=False))
    return request.param, jwl, jcfg, jrun, tf(), tcore.EngineConfig(**kw)


def _seeds():
    return np.arange(N_SEEDS, dtype=np.uint64) * np.uint64(977)


def test_reference_file_resumes_in_the_port(case, tmp_path):
    _name, jwl, jcfg, jrun, wl, cfg = case
    jmid = jrun(je.make_init(jwl, jcfg, time32=False)(_seeds()))
    path = str(tmp_path / "ref.npz")
    je.save_checkpoint(path, jmid, jcfg)
    mid = load(path, cfg, device="cpu")
    assert_same_state(jmid, mid)
    resumed = tcore.make_run(wl, cfg, SPLIT)(mid)
    whole = tcore.make_run(wl, cfg, 2 * SPLIT)(tcore.make_init(wl, cfg, device="cpu")(_seeds()))
    for f in tcore.STATE_FIELDS:
        assert getattr(resumed, f).equal(getattr(whole, f)), f
    if _name.endswith("-record"):
        assert mid.hist_count.min() > 0 and resumed.hist_count.max() > mid.hist_count.max()


def test_port_file_resumes_in_the_reference(case, tmp_path):
    _name, jwl, jcfg, jrun, wl, cfg = case
    mid = tcore.make_run(wl, cfg, SPLIT)(tcore.make_init(wl, cfg, device="cpu")(_seeds()))
    path = str(tmp_path / "port.npz")
    save(path, mid, cfg)
    jmid = je.load_checkpoint(path, jcfg, time32=False)
    assert_same_state(jmid, mid)
    whole = jrun(jrun(je.make_init(jwl, jcfg, time32=False)(_seeds())))
    want, got = jax_fields(whole), jax_fields(jrun(jmid))
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    # and back: the port reads its own file
    again = load(path, cfg, device="cpu")
    for f in tcore.STATE_FIELDS:
        assert getattr(again, f).equal(getattr(mid, f)), f


@pytest.mark.parametrize(
    "jf,tf,kw",
    [(j_raft, make_raft, BENCH_SPECS["raft"][1]),
     (lambda: j_kvchaos(payload=True), lambda: make_kvchaos(payload=True),
      BENCH_SPECS["kvchaos"][1]),
     (j_shardkv, make_shardkv, SOAK_SPECS["shardkv"][1])],
    ids=["raft", "kvchaos-payload", "shardkv"],
)
def test_foreign_entries_are_the_reference_fields(jf, tf, kw, tmp_path):
    """The port's SimState has every field of the reference's but the
    pool-index summaries, and its file holds each with the reference's
    dtype and shape."""
    jcfg = je.EngineConfig(**kw)
    jst = je.make_init(jf(), jcfg, time32=False)(np.arange(3, dtype=np.uint64))
    want = {f: v for f, v in jax_fields(jst).items() if f not in POOL_INDEX_STATE_FIELDS}
    path = str(tmp_path / "port.npz")
    save(path, tcore.make_init(tf(), tcore.EngineConfig(**kw), device="cpu")(np.arange(3)),
         tcore.EngineConfig(**kw))
    with np.load(path) as data:
        got = {f: data[f] for f in data.files if f != "__madsim_manifest__"}
    assert set(got) == set(want) == set(tcore.STATE_FIELDS)
    for f in tcore.STATE_FIELDS:
        assert (got[f].dtype, got[f].shape) == (want[f].dtype, want[f].shape), f


def _rewrite(path, **entries):
    """The checkpoint at ``path`` with ``entries`` replaced."""
    with np.load(path) as data:
        arrays = {f: data[f] for f in data.files}
    arrays.update(entries)
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


@pytest.fixture
def port_file(tmp_path):
    wl, cfg = make_raft(), tcore.EngineConfig(**BENCH_SPECS["raft"][1])
    path = str(tmp_path / "ck.npz")
    save(path, tcore.make_init(wl, cfg, device="cpu")(np.arange(4)), cfg)
    return path, cfg


def test_refuses_another_config(port_file):
    path, _cfg = port_file
    with pytest.raises(ValueError, match="different EngineConfig"):
        load(path, tcore.EngineConfig(pool_size=40, loss_p=0.5), device="cpu")


def test_refuses_a_time32_checkpoint(tmp_path):
    kw = BENCH_SPECS["raft"][1]
    jcfg = je.EngineConfig(**kw)
    path = str(tmp_path / "t32.npz")
    je.save_checkpoint(path, je.make_init(j_raft(), jcfg, time32=True)(np.arange(4, dtype=np.uint64)), jcfg)
    with pytest.raises(ValueError, match="time32"):
        load(path, tcore.EngineConfig(**kw), device="cpu")


@pytest.mark.parametrize(
    "field,value,item",
    [("lat_count", np.array([0, 3, 0, 0], np.int32), "A8"),
     ("tl_seq", np.zeros((4, 5), np.int32), "A8"),
     ("lam", np.zeros((4, 1), np.uint32), "A8"),
     ("rt_done", np.zeros((4, 1), np.bool_), "A8")],
)
def test_refuses_a_non_empty_foreign_field(port_file, field, value, item):
    """No field of the reference is foreign to the port since the retry
    axis: the latency, causal and retry columns load as they are (a
    retry column under the spec of its width)."""
    path, cfg = port_file
    _rewrite(path, **{field: value})
    assert field in tcore.STATE_FIELDS and item == "A8"
    retry = None
    if field == "rt_done":
        retry = tcore.RetrySpec(kind=tcore.FIRST_USER_KIND, node=0, op_base=0, n_ops=1,
                                timeout_ns=1)
        with pytest.raises(ValueError, match="retry columns for 1 ops"):
            load(path, cfg, device="cpu")
    np.testing.assert_array_equal(
        getattr(load(path, cfg, device="cpu", retry=retry), field).numpy(), value)


def test_refuses_an_unknown_format(port_file):
    path, cfg = port_file
    manifest = json.dumps({"format": 10, "config_hash": cfg.hash(), "ev_time_dtype": "int64"})
    _rewrite(path, __madsim_manifest__=np.frombuffer(manifest.encode(), np.uint8))
    with pytest.raises(ValueError, match="unknown checkpoint format 10"):
        load(path, cfg, device="cpu")


def test_save_writes_the_path_verbatim(tmp_path):
    wl, cfg = make_raft(), tcore.EngineConfig(pool_size=40)
    path = tmp_path / "no_suffix"
    save(str(path), tcore.make_init(wl, cfg, device="cpu")(np.arange(2)), cfg)
    assert path.exists() and not (tmp_path / "no_suffix.npz").exists()
