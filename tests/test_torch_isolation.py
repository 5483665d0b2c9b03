"""The torch port stands alone: it imports neither JAX nor the JAX
package, runs on the card unless asked for the CPU, and carries state
across from the JAX package with the reference's dtypes intact."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import madsim_tpu.engine as je
from madsim_tpu.models import make_raft as j_raft
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.convert import (
    NUMPY_DTYPES, state_from_numpy, state_to_numpy, tables_from_numpy,
    tables_to_numpy,
)
from madsim_tpu_torch.models import make_raft as t_raft

from _torch_parity import jax_fields

ROOT = Path(__file__).resolve().parent.parent


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, madsim_tpu_torch, madsim_tpu_torch.engine.fused, "
        "madsim_tpu_torch.models, madsim_tpu_torch.check.device, "
        "madsim_tpu_torch.chaos, madsim_tpu_torch.explore, madsim_tpu_torch.obs, "
        "madsim_tpu_torch.farm, madsim_tpu_torch.parallel, madsim_tpu_torch.lint, "
        "madsim_tpu_torch.runtime, madsim_tpu_torch.net, madsim_tpu_torch.fs, "
        "madsim_tpu_torch.chaos.nemesis, madsim_tpu_torch.check.recorder, "
        "madsim_tpu_torch.sync, madsim_tpu_torch.compat, madsim_tpu_torch.std, "
        "madsim_tpu_torch.std.fastpath, madsim_tpu_torch.std.uring, "
        "madsim_tpu_torch.services, madsim_tpu_torch.services.grpc_codegen\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'madsim_tpu' or m.startswith('madsim_tpu.')]\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, check=True, timeout=120,
    )
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_mentions_the_jax_package_or_jax():
    pat = re.compile(
        r"^\s*(from|import)\s+(madsim_tpu(\.|\s|$)|jax(\.|\s|$))", re.M
    )
    files = sorted((ROOT / "madsim_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 9
    assert ROOT / "madsim_tpu_torch" / "chaos" / "shrink.py" in files
    for f in files:
        assert not pat.search(f.read_text()), f


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcore.EngineConfig(pool_size=40)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.make_init(t_raft(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcore.make_init(t_raft(), cfg, device="cuda")
    st = tcore.make_init(t_raft(), cfg, device="cpu")(np.arange(3))
    assert st.device.type == "cpu"


def test_state_round_trip_keeps_the_reference_dtypes():
    cfg = je.EngineConfig(pool_size=40, loss_p=0.02)
    seeds = np.array([0, 5, 2**63 + 3, 2**64 - 1], np.uint64)
    jst = je.make_run(j_raft(), cfg, 25, layout="scatter", time32=False)(
        je.make_init(j_raft(), cfg, time32=False)(seeds)
    )
    fields = jax_fields(jst)
    back = state_to_numpy(state_from_numpy(fields))
    assert set(back) == set(NUMPY_DTYPES)
    for name, v in back.items():
        assert v.dtype == fields[name].dtype, name
        np.testing.assert_array_equal(v, fields[name], err_msg=name)
    # a state carried across steps on in the port exactly as in JAX
    tst = tcore.make_run(t_raft(), tcore.EngineConfig(pool_size=40, loss_p=0.02), 5)(
        state_from_numpy(fields)
    )
    jnext = je.make_run(j_raft(), cfg, 5, layout="scatter", time32=False)(jst)
    want = jax_fields(jnext)
    for name, v in state_to_numpy(tst).items():
        np.testing.assert_array_equal(v, want[name], err_msg=name)
    with pytest.raises(TypeError, match="dtype"):
        state_from_numpy(dict(fields, step=fields["step"].astype(np.int64)))


def test_workload_tables_round_trip():
    ir, vo = tables_to_numpy(t_raft())
    np.testing.assert_array_equal(ir, j_raft().initial_state())
    np.testing.assert_array_equal(vo, j_raft().volatile_mask())
    tir, tvo = tables_from_numpy(ir, vo)
    assert tir.dtype == torch.int32 and tvo.dtype == torch.bool
    ir2, vo2 = tir.numpy(), tvo.numpy()
    assert ir2.dtype == ir.dtype and vo2.dtype == vo.dtype
    np.testing.assert_array_equal(ir2, ir)
    np.testing.assert_array_equal(vo2, vo)


def test_the_single_seed_layers_import_no_torch():
    """The runtime, the network and filesystem simulators, the Recorder,
    ``sync``, ``compat``, the real backend ``std`` and the service
    simulators hold no tensors: none of their modules imports torch (the
    Nemesis reaches the engine's kind table, as its JAX twin does)."""
    pat = re.compile(r"^\s*(from|import)\s+(torch|numpy\.|\.\.?engine)", re.M)
    pkg = ROOT / "madsim_tpu_torch"
    files = (sorted((pkg / "runtime").glob("*.py")) + sorted((pkg / "net").glob("*.py"))
             + [pkg / "fs.py", pkg / "check" / "recorder.py", pkg / "sync.py"]
             + sorted((pkg / "compat").glob("*.py")) + sorted((pkg / "std").glob("*.py"))
             + sorted((pkg / "services").glob("*.py")))
    assert len(files) == 14 + 11 + 3 + 2 + 8 + 7
    for f in files:
        assert not pat.search(f.read_text()), f
