"""``python -m madsim_tpu_torch.lint`` — the port's lint entry point.

Runs the nondeterminism-leak linter over the port (fails on any
finding, an unused pragma included), as ``python -m madsim_tpu.lint``
does over the JAX package. The JAX package's ``--jaxpr`` and
``--absint`` smokes walk traced jaxprs; the port has no jaxpr (an eager
torch step and a CUDA kernel outside any graph), so its two smokes are
dynamic and source-level instead:

* ``--noninterference`` perturbs the derived columns of raft/record
  (every tap), kvchaos/army (the latency tap) and raftlog/durable (the
  storage columns core) within their contracts through the plain step
  on the CPU, each model's contracts at its certification horizon
  (``absint_entries()``), and requires the core columns and the trace
  to stay equal (``lint.noninterference.check_matrix``);
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


def smoke_reports() -> list:
    """The ``--noninterference`` smoke's reports, on the CPU, each model
    at its certification horizon."""
    import numpy as np

    from .noninterference import check_matrix

    return check_matrix(SMOKE, seeds=np.arange(SMOKE_SEEDS, dtype=np.uint64),
                        n_steps=SMOKE_STEPS, device="cpu")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m madsim_tpu_torch.lint",
        description="determinism analysis of the torch port (madsim_tpu_torch.lint)",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the port's package)")
    ap.add_argument("--noninterference", action="store_true",
                    help="also run the perturbation smoke (raft/record, kvchaos/army, "
                         "raftlog/durable through the plain step)")
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
    reports = smoke_reports() if args.noninterference else []
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
