"""``torch.distributed`` worlds for the port's parallel tests, made
through a ``file://`` store (no port): a world of one rank in the test's
own process, and a spawned gloo world of several ranks, each rank a
process of this file that runs :func:`world_cases` and, on rank 0,
pickles what it got for the test to compare with the unsharded runs.

    python tests/_torch_world.py SIZE RANK STORE OUT [CASES]
"""

import contextlib
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# the world's cases: shapes small enough for the plain step on a CPU
COMPACT_SEEDS = 60
COMPACT_STEPS = 600
MERGE_ROWS = 96
DEVICE_RUN = dict(generations=3, batch=24, root_seed=11, max_steps=600, cov_words=16)


@contextlib.contextmanager
def one_rank_world():
    """A gloo world of one rank in this process, torn down on exit."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory(prefix="madsim_world_") as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=1,
                                rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


def spawn_world(size: int, timeout: float = 300.0, cases: str = "world_cases") -> dict:
    """Run ``cases`` (a function of this file taking the mesh:
    :func:`world_cases` by default) on a spawned gloo world of ``size``
    ranks; rank 0's results. Raises with every rank's output if one
    fails."""
    with tempfile.TemporaryDirectory(prefix="madsim_world_") as tmp:
        store, out = f"{tmp}/store", f"{tmp}/out.pkl"
        env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'tests'}",
                   OMP_NUM_THREADS="1")
        procs = [
            subprocess.Popen([sys.executable, __file__, str(size), str(r), store, out, cases],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(size)
        ]
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError("a rank of the world failed:\n" + "\n".join(
                f"--- rank {r} (rc {p.returncode})\n{log}"
                for r, (p, log) in enumerate(zip(procs, logs))))
        with open(out, "rb") as fh:
            return pickle.load(fh)


def case_inputs(seed: int = 5) -> dict:
    """The merges' inputs: per-seed bitmaps, metric rows, sketches and
    verdicts, made from a seed with numpy (the whole batch)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return dict(
        cov=(rng.integers(0, 2**32, size=(MERGE_ROWS, 8), dtype=np.uint64)
             & rng.integers(0, 2**32, size=(MERGE_ROWS, 8), dtype=np.uint64)
             ).astype(np.uint32),
        met=rng.integers(0, 2**31 - 1, size=(MERGE_ROWS, 16)).astype(np.int32),
        lat=rng.integers(0, 1000, size=(MERGE_ROWS, 2, 12)).astype(np.int32),
        ok=rng.random(MERGE_ROWS) < 0.7,
    )


def compact_case(tm, tcore, tdc):
    """kvchaos-bug (writes 5) with the history screens at the shape of
    ``tests/test_torch_screen_search.py`` (pool 40, a 600-step cap: some
    seeds flagged, some stopped by the cap): the workload, config, seeds
    and screens the compacted cases run."""
    import numpy as np

    wl = tm.make_kvchaos(writes=5, record=True, bug=True)
    cfg = tcore.EngineConfig(pool_size=40, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
    screens = (tdc.stale_reads(), tdc.read_your_writes(), tdc.monotonic_reads())
    return wl, cfg, np.arange(COMPACT_SEEDS, dtype=np.uint64), screens


def world_cases(mesh) -> dict:
    """Everything the parallel tests compare, run SPMD on ``mesh``."""
    import numpy as np
    import torch

    import madsim_tpu_torch.chaos as tch
    import madsim_tpu_torch.explore as tx
    import madsim_tpu_torch.models as tm
    from madsim_tpu_torch import parallel as par
    from madsim_tpu_torch.check import device as tdc
    from madsim_tpu_torch.engine import core as tcore

    from _torch_explore import halt_inv, raft_plan

    out = {}
    try:
        par.make_mesh()
    except ValueError as e:
        out["mesh_default"] = str(e)
    wl, cfg, seeds, screens = compact_case(tm, tcore, tdc)
    st = tcore.make_init(wl, cfg, device="cpu")(seeds)
    run = par.shard_run_compacted(wl, cfg, COMPACT_STEPS, mesh, shrink=2, min_size=4,
                                  hist_screen=screens)
    out["compacted"] = vars(run(st))
    try:
        run(tcore.make_init(wl, cfg, device="cpu")(seeds[:COMPACT_SEEDS - 1]))
    except ValueError as e:
        out["uneven"] = str(e)
    lock = par.shard_over_seeds(tcore.make_run_while(wl, cfg, COMPACT_STEPS), mesh)(st)
    out["lockstep_trace"] = lock.trace.numpy()
    out["lockstep_hist_word"] = lock.hist_word.numpy()

    inp = case_inputs()
    local = MERGE_ROWS // mesh.size
    mine = {k: v[mesh.rank * local:(mesh.rank + 1) * local] for k, v in inp.items()}
    out["merge_coverage"] = par.merge_coverage(mine["cov"], mesh)
    out["merge_metrics"] = par.merge_metrics(torch.from_numpy(mine["met"]), mesh)
    out["merge_latency"] = par.merge_latency(mine["lat"], mesh)
    out["merge_verdicts"] = par.merge_verdicts(mine["ok"], mesh)
    try:
        par.merge_verdicts(mine["ok"][:local - 1], mesh)
    except ValueError as e:
        out["verdicts_uneven"] = str(e)

    records = []
    rep = tx.run_device(tm.make_raft(), tcore.EngineConfig(pool_size=64, loss_p=0.02),
                        raft_plan(tch, name="device-explore-test"), invariant=halt_inv,
                        mesh=mesh, telemetry=records.append, **DEVICE_RUN)
    out["device"] = rep
    out["device_records"] = records
    try:
        tx.run_device(tm.make_raft(), tcore.EngineConfig(pool_size=64, loss_p=0.02),
                      raft_plan(tch, name="device-explore-test"), invariant=halt_inv,
                      mesh=mesh, **dict(DEVICE_RUN, batch=DEVICE_RUN["batch"] + 1))
    except ValueError as e:
        out["device_uneven"] = str(e)
    return out


def lint_axes_cases(mesh) -> dict:
    """The sharded-campaign row of ``lint.CAMPAIGN_AXES`` on ``mesh``:
    ``lint.check_campaign`` of a small raft-record campaign (the case of
    ``tests/test_torch_lint_axes.py``), its report as a dict."""
    from madsim_tpu_torch.lint import CAMPAIGN_AXES, check_campaign

    from _torch_lint_axes import RAFT_CASE, raft_case

    wl, cfg, plan, judge = raft_case()
    rep = check_campaign(wl, cfg, plan, mesh=mesh, **judge, **RAFT_CASE,
                         **CAMPAIGN_AXES["sharded-campaign"])
    return {"report": rep.to_dict()}


def main() -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    size, rank, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    cases = globals()[sys.argv[5] if len(sys.argv) > 5 else "world_cases"]
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=size,
                            rank=rank)
    try:
        from madsim_tpu_torch.parallel import make_mesh

        got = cases(make_mesh(device="cpu"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump(got, fh)


if __name__ == "__main__":
    main()
