"""``python -m madsim_tpu_torch.lint`` — the port's lint entry point.

Runs the nondeterminism-leak linter over the port (fails on any
finding, an unused pragma included), as ``python -m madsim_tpu.lint``
does over the JAX package. The JAX package's ``--jaxpr`` and
``--absint`` smokes walk traced jaxprs; the port has no jaxpr (an eager
torch step and a CUDA kernel outside any graph), so its two smokes are
dynamic and source-level instead:

* ``--noninterference`` perturbs derived columns within their contracts
  before every chunk of a run, each model's contracts at its
  certification horizon (``absint_entries()``), and requires the core
  columns and the trace to stay equal. It runs on the card unless
  ``--device cpu`` asks for the CPU, and raises without a card. On the
  card it goes through the run kernel (``engine.make_run``) on libraries
  that have the build (:data:`CARD_SMOKE`: raft 40 with metrics and every
  tap, raft-record 40, kvchaos-bug-nochaos 192 with metrics, a ring and
  the causal axis under a crash storm, raftlog-durable-spread 64 with
  the coverage taps, kvchaos-army-nochaos 160 with every tap and the
  latency tap under its client army); a cell whose library lacks the
  build raises. On the CPU it runs :data:`SMOKE` through the plain step:
  raft/record (every tap), kvchaos/army (the latency tap) and
  raftlog/durable (the storage columns core)
  (``lint.noninterference.check_matrix``);
* ``--lanes`` scans every draw site of the port and resolves it to its
  registered threefry lane, checks each lane's owner, the models'
  ``draw_purposes`` and the run kernel's purpose constants
  (``lint.absint``).

Exit status 0 = clean, 1 = findings. ``--format json`` prints one
machine-readable object (findings, the allowlist inventory, the
reports); ``--json`` is the legacy spelling.
"""

from __future__ import annotations

import argparse
import json
import sys

# the --noninterference smoke: (tag, axis) rows of model_matrix x BUILD_AXES
SMOKE = (("raft/record", "all"), ("kvchaos/army", "latency"), ("raftlog/durable", "base"))
SMOKE_SEEDS = 16
SMOKE_STEPS = 120


# on the card: seeds a cell, and the cells (tag, steps, build flags):
# libraries with the build, at their card phases' configs and step caps
CARD_SEEDS = 1024


def card_smoke() -> list:
    """The card cells of the ``--noninterference`` smoke: ``(tag,
    workload, config, plan or None, steps, build flags, horizon ns)``,
    each a library the run kernel is built for at its pool, with the
    taps where the library has the ``OBS`` build."""
    from ..chaos import CrashStorm, FaultPlan, GrayFailure
    from ..engine.core import EngineConfig, LatencySpec
    from ..models import kvchaos, raft, raftlog

    b2 = dict(clog_backoff_max_ns=2_000_000_000)
    raft_cfg = EngineConfig(pool_size=40, loss_p=0.02, **b2)
    taps = dict(cov_words=64, cov_hitcount=True, timeline_cap=256)
    crash = FaultPlan((CrashStorm(targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000,
                                  t_max_ns=400_000_000, down_min_ns=50_000_000,
                                  down_max_ns=250_000_000),), name="kv-nemesis")
    army = kvchaos.client_army(n_ops=64, t_min_ns=5_000_000, t_max_ns=500_000_000,
                               n_replicas=2)
    gray = FaultPlan((army, GrayFailure(targets=(0, 3), n_links=1, mult_min=8, mult_max=16,
                                        t_min_ns=20_000_000, t_max_ns=250_000_000,
                                        dur_min_ns=250_000_000, dur_max_ns=450_000_000)),
                     name="army-gray")
    return [
        ("raft/taps", raft.make_raft(), raft_cfg, None, 600, dict(metrics=True, **taps),
         raft.ABSINT_HORIZON_NS),
        ("raft/record", raft.make_raft(record=True), raft_cfg, None, 600, {},
         raft.ABSINT_HORIZON_NS),
        ("kvchaos/bug-causal", kvchaos.make_kvchaos(writes=10, record=True, bug=True,
                                                    chaos=False),
         EngineConfig(pool_size=192, loss_p=0.05), crash, 4000,
         dict(metrics=True, timeline_cap=128, causal=True), kvchaos.ABSINT_HORIZON_NS),
        ("raftlog/durable-spread", raftlog.make_raftlog(durable=True, cov_spread=True),
         EngineConfig(pool_size=64, loss_p=0.02, **b2), None, 4000,
         dict(cov_words=64, cov_hitcount=True), raftlog.ABSINT_HORIZON_NS),
        ("kvchaos/army-slo", kvchaos.make_kvchaos(writes=20, n_replicas=2, chaos=False,
                                                  army=True, army_probes=3),
         EngineConfig(pool_size=160, time_limit_ns=700_000_000), gray, 4000,
         dict(metrics=True, latency=LatencySpec(ops=64, phases=2, phase_ns=1 << 28), **taps),
         kvchaos.ABSINT_HORIZON_NS),
    ]


def smoke_reports(device=None) -> list:
    """The ``--noninterference`` smoke's reports, each model at its
    certification horizon: on the card (the default; raises without
    one) through the run kernel over :func:`card_smoke`, on the CPU
    (``device="cpu"``) through the plain step over :data:`SMOKE`."""
    import numpy as np

    from ..engine.core import make_init, make_run, resolve_device
    from .noninterference import check_matrix, check_noninterference

    dev = resolve_device(device)
    if dev.type == "cpu":
        return check_matrix(SMOKE, seeds=np.arange(SMOKE_SEEDS, dtype=np.uint64),
                            n_steps=SMOKE_STEPS, device=dev)
    reports = []
    seeds = np.arange(CARD_SEEDS, dtype=np.uint64)
    for tag, wl, cfg, plan, steps, flags, horizon in card_smoke():
        init = make_init(wl, cfg, device=dev, plan_slots=plan.slots if plan else 0, **flags)
        st = init(seeds, plan.compile_batch(seeds, wl=wl)) if plan else init(seeds)
        rep = check_noninterference(wl, cfg, run=make_run, seeds=st, n_steps=steps,
                                    horizon_ns=horizon, **flags)
        rep.flags["axis"] = tag
        reports.append(rep)
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m madsim_tpu_torch.lint",
        description="determinism analysis of the torch port (madsim_tpu_torch.lint)",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the port's package)")
    ap.add_argument("--noninterference", action="store_true",
                    help="also run the perturbation smoke (through the run kernel on the "
                         "card; --device cpu: raft/record, kvchaos/army, raftlog/durable "
                         "through the plain step)")
    ap.add_argument("--device", default=None,
                    help="where --noninterference runs: the card by default (raises "
                         "without one), or cpu")
    ap.add_argument("--lanes", action="store_true",
                    help="also run the lane registry check over every draw site")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="output format (json = one machine-readable object for CI)")
    ap.add_argument("--json", action="store_true", help="legacy alias for --format json")
    ap.add_argument("--show-allowed", action="store_true",
                    help="print the checked allowlist (pragma inventory)")
    args = ap.parse_args(argv)
    as_json = args.json or args.format == "json"

    from .rules import lint_paths, lint_repo

    result = lint_paths(args.paths) if args.paths else lint_repo()
    reports = smoke_reports(args.device) if args.noninterference else []
    lanes = None
    if args.lanes:
        from .absint import check_lanes

        lanes = check_lanes()

    if as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in result.findings],
            "allowed": [f.to_dict() for f in result.allowed],
            "n_files": result.n_files,
            "noninterference": [r.to_dict() for r in reports],
            "lanes": lanes,
        }, sort_keys=True))
    else:
        for f in result.findings:
            print(str(f))
            if f.snippet:
                print(f"    {f.snippet}")
        if args.show_allowed:
            for f in result.allowed:
                print(f"ALLOWED {f}")
        for r in reports:
            print(r.summary())
        if lanes is not None:
            for f in lanes["findings"]:
                print(f"{f['file']}:{f['line']}: [{f['rule']}] {f['message']}")
            print(f"lanes: {lanes['sites']} draw sites over lanes {{"
                  f"{', '.join(lanes['lanes'])}}}, {len(lanes['findings'])} finding(s)")
        print(
            f"lint: {result.n_files} files, {len(result.findings)} finding(s), "
            f"{len(result.allowed)} allowlisted site(s)"
            + (f", {len(reports)} non-interference checks" if reports else "")
        )

    bad = (bool(result.findings) or any(not r.ok for r in reports)
           or bool(lanes and lanes["findings"]))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
