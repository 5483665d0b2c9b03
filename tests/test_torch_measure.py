"""The port's measurement harness against the JAX package's.

The repeat program's device sums equal separate compacted runs of the
same seed blocks and the reference's repeat program (the measurement is
about the computation the engine runs), and the returned dicts carry
the reference's keys letter for letter, plus the port's CUDA-event
times (``None`` on the CPU). Exact equality for the sums.
"""

import _torch_threads  # noqa: F401
import numpy as np
import pytest

import madsim_tpu.engine as je
from madsim_tpu.engine import measure as jmeasure
from madsim_tpu.models import make_microbench as j_microbench
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine.compact import make_run_compacted
from madsim_tpu_torch.engine.measure import (
    make_repeat_program,
    measure_latency,
    measure_throughput,
    null_dispatch_stats,
)
from madsim_tpu_torch.models import make_microbench


def test_repeat_program_matches_separate_runs_and_reference():
    wl, cfg = make_microbench(rounds=40), tcore.EngineConfig(pool_size=16)
    n_seeds, repeats, seed_mod = 32, 3, 64
    program = make_repeat_program(wl, cfg, 400, n_seeds, seed_mod, min_size=8, device="cpu")
    got = tuple(int(x) for x in program(5, repeats))

    init = tcore.make_init(wl, cfg, device="cpu")
    run = make_run_compacted(wl, cfg, 400, min_size=8, fields=("now", "overflow", "halted"))
    want = [0, 0, 0]
    for r in range(repeats):
        seeds = (5 + r * n_seeds + np.arange(n_seeds, dtype=np.uint64)) % seed_mod
        out = run(init(seeds))
        want[0] += int(out.now.sum())
        want[1] += int(out.overflow.sum())
        want[2] += int(out.halted.sum())
    assert got == tuple(want)
    assert got[2] == repeats * n_seeds

    jprog = jmeasure.make_repeat_program(
        j_microbench(rounds=40), je.EngineConfig(pool_size=16), 400, n_seeds, seed_mod,
        time32=False, min_size=8,
    )
    assert got == tuple(int(x) for x in jprog(np.uint64(5), repeats))


def test_seeds_wrap_at_seed_mod():
    wl, cfg = make_microbench(rounds=5), tcore.EngineConfig(pool_size=8)
    program = make_repeat_program(wl, cfg, 200, 8, 8, min_size=8, device="cpu")
    # seed_mod == n_seeds: every batch is seeds 0..7, whatever the base
    assert [int(x) for x in program(3, 2)] == [2 * int(x) for x in program(0, 1)]
    with pytest.raises(ValueError, match="seed_mod"):
        make_repeat_program(wl, cfg, 200, 8, 4, device="cpu")


@pytest.fixture(scope="module")
def reference_records():
    """The reference's dicts at the sizes of ``tests/test_measure.py``."""
    wl, cfg = j_microbench(rounds=5), je.EngineConfig(pool_size=8)
    thr = jmeasure.measure_throughput(wl, cfg, 200, 64, target_wall_s=0.2, n_measure=2,
                                      seed_mod=128, min_size=16)
    lat = jmeasure.measure_latency(wl, cfg, 200, target_wall_s=0.2, n_measure=2, seed_mod=128)
    return thr, lat, jmeasure.null_dispatch_stats(n=5)


def test_measure_throughput_reports_quotable_cell(reference_records):
    wl, cfg = make_microbench(rounds=5), tcore.EngineConfig(pool_size=8)
    rec = measure_throughput(wl, cfg, 200, 64, target_wall_s=0.2, n_measure=2,
                             seed_mod=128, min_size=16, device="cpu")
    assert set(rec) == set(reference_records[0]) | {"device_walls_s"}
    assert rec["device_walls_s"] is None
    assert rec["overflow"] == 0 and rec["all_halted"]
    assert rec["sim_s_per_s_min"] <= rec["sim_s_per_s_median"] <= rec["sim_s_per_s_max"]
    assert rec["sim_s_per_s_median"] > 0
    assert len(rec["dispatch_walls_s"]) == 2 and rec["repeats"] >= 1


def test_measure_latency_reports_quotable_cell(reference_records):
    wl, cfg = make_microbench(rounds=5), tcore.EngineConfig(pool_size=8)
    rec = measure_latency(wl, cfg, 200, target_wall_s=0.2, n_measure=2, seed_mod=128,
                          device="cpu")
    assert set(rec) == set(reference_records[1]) | {"device_walls_s"}
    assert rec["overflow"] == 0 and rec["all_halted"] and rec["n_seeds"] == 1
    assert rec["wall_us_per_sim_median"] > 0 and rec["sim_s_per_s"] > 0
    assert len(rec["dispatch_walls_s"]) == 2 and rec["repeats"] >= 32


def test_null_dispatch_stats_shape(reference_records):
    s = null_dispatch_stats(n=5, device="cpu")
    assert set(s) == set(reference_records[2]) | {"device_median_ms"}
    assert s["n"] == 5 and s["device_median_ms"] is None
    assert 0 <= s["min_ms"] <= s["median_ms"] <= s["max_ms"]
