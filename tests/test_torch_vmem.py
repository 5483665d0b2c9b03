"""The port against the TPU kernel itself: kvchaos with the payload
arena, and raft recording its election history, through the JAX
package's Pallas runner (``madsim_tpu/engine/vmem.py:make_run_vmem``,
interpret mode on the CPU) and through the port's runner, which on a
card is the run kernel (``csrc/run_kernel.cu``) and here the plain step
the kernel is held against. Every field equal, payload and history
rows included."""

import numpy as np

import madsim_tpu.engine as je
from madsim_tpu.engine.vmem import make_run_vmem
from madsim_tpu.models import make_kvchaos as j_make
from madsim_tpu.models import make_raft as j_raft
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.convert import state_to_numpy
from madsim_tpu_torch.models import BENCH_SPECS
from madsim_tpu_torch.models import make_kvchaos as t_make
from madsim_tpu_torch.models import make_raft as t_raft

from _torch_parity import assert_same_state


def test_port_matches_the_pallas_kernel_on_kvchaos_payload():
    kw = BENCH_SPECS["kvchaos"][1]
    seeds = np.arange(16, dtype=np.uint64) * np.uint64(7919)
    jwl, twl = j_make(payload=True), t_make(payload=True)
    jcfg, tcfg = je.EngineConfig(**kw), tcore.EngineConfig(**kw)
    js = je.make_init(jwl, jcfg, time32=False)(seeds)
    jo = make_run_vmem(jwl, jcfg, 40, block_seeds=16, layout="scatter",
                       time32=False, interpret=True)(js)
    to = tcore.make_run(twl, tcfg, 40)(tcore.make_init(twl, tcfg, device="cpu")(seeds))
    assert_same_state(jo, to)
    t = state_to_numpy(to)
    assert t["ev_pay"].any() and t["ev_valid"].any(axis=1).all()


def test_port_matches_the_pallas_kernel_on_raft_record():
    """The history axis of the TPU kernel: the hist_* columns it loads
    and stores, and the append inside its step, against the port."""
    kw = BENCH_SPECS["raft"][1]
    seeds = np.arange(16, dtype=np.uint64) * np.uint64(31)
    jwl, twl = j_raft(record=True), t_raft(record=True)
    jcfg, tcfg = je.EngineConfig(**kw), tcore.EngineConfig(**kw)
    js = je.make_init(jwl, jcfg, time32=False)(seeds)
    jo = make_run_vmem(jwl, jcfg, 80, block_seeds=16, layout="scatter",
                       time32=False, interpret=True)(js)
    to = tcore.make_run(twl, tcfg, 80)(tcore.make_init(twl, tcfg, device="cpu")(seeds))
    assert_same_state(jo, to)
    t = state_to_numpy(to)
    assert (t["hist_count"] >= 1).all() and t["hist_word"].shape == (16, 8, 5)
