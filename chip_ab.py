"""Time ``chip_smoke.py`` of another checkout and of this one in one call.

    python3 chip_ab.py OTHER_DIR [--pairs N KEYS] [CARD_TESTS ...]

Runs ``python3 chip_smoke.py`` from the root of ``OTHER_DIR`` (for
example the parent commit unpacked by ``git archive`` into a directory
that ``.gitignore`` lists), then from this checkout, each in its own
process, and prints each one's exit code and wall seconds on the host
clock, so that two versions of the script compare on one card in one
call. ``--pairs N KEYS`` (KEYS comma-separated model keys, e.g.
``raft,kvchaos,raftlog``) then times those libraries' kernels in
alternating pairs, N runs of ``chip_smoke.py --groups 8 KEYS`` on each
side in the order other, this, this, other, ..., and prints each side's
per-run medians and their spread per library. With test files after
it, it then runs them with ``python3 -m pytest -m cuda --noconftest``
(the card tests). The full outputs go to ``build/ab/other.log``,
``build/ab/this.log``, ``build/ab/pair_<side>_<i>.log`` and
``build/ab/card_tests.log``; the summary is the last lines. Exits
non-zero if any of them failed.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "ab"
# a line of chip_smoke.py --groups: "  <key> G=<g>: median <ms> ms, ..."
SWEEP_LINE = re.compile(r"^\s+(\S+) G=\d+: median ([0-9.]+) ms")


def run(name: str, cmd: list, cwd: Path) -> int:
    log = OUT / f"{name}.log"
    t = time.perf_counter()
    with open(log, "w") as fh:
        rc = subprocess.run(cmd, cwd=cwd, stdout=fh, stderr=subprocess.STDOUT).returncode
    s = time.perf_counter() - t
    tail = log.read_text().splitlines()[-1:] or [""]
    print(f"{name}: exit {rc} in {s:.1f} s; last line: {tail[0][:200]}", flush=True)
    return rc


def pairs(other: Path, n: int, keys: str) -> list:
    """``n`` alternating timing runs a side; prints each side's medians
    per library. Returns the exit codes."""
    sides = {"other": other, "this": ROOT}
    medians = {side: {} for side in sides}
    rcs = []
    for i in range(n):
        for side in (("other", "this") if i % 2 == 0 else ("this", "other")):
            name = f"pair_{side}_{i}"
            rcs.append(run(name, [sys.executable, "chip_smoke.py", "--groups", "8",
                                  *keys.split(",")], sides[side]))
            for line in (OUT / f"{name}.log").read_text().splitlines():
                m = SWEEP_LINE.match(line)
                if m:
                    medians[side].setdefault(m.group(1), []).append(float(m.group(2)))
    for key in keys.split(","):
        for side in sides:
            ms = medians[side].get(key, [])
            if ms:
                print(f"pairs {key} {side}: medians {ms}; median {statistics.median(ms):.4f} "
                      f"ms, spread {min(ms):.4f}..{max(ms):.4f}", flush=True)
    return rcs


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other, rest = Path(sys.argv[1]).resolve(), sys.argv[2:]
    n_pairs, keys = 0, ""
    if rest[:1] == ["--pairs"]:
        n_pairs, keys, rest = int(rest[1]), rest[2], rest[3:]
    tests = rest
    OUT.mkdir(parents=True, exist_ok=True)
    rcs = [run("other", [sys.executable, "chip_smoke.py"], other),
           run("this", [sys.executable, "chip_smoke.py"], ROOT)]
    if n_pairs:
        rcs += pairs(other, n_pairs, keys)
    if tests:
        rcs.append(run("card_tests", [sys.executable, "-m", "pytest", "-m", "cuda",
                                      "--noconftest", "-q", "-p", "no:cacheprovider", *tests],
                       ROOT))
    for line in (OUT / "this.log").read_text().splitlines():
        if line.startswith("[time]"):
            print(line)
    return 0 if not any(rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
