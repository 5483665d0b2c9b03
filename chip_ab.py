"""Time ``chip_smoke.py`` of another checkout and of this one in one call.

    python3 chip_ab.py OTHER_DIR [CARD_TESTS ...]

Runs ``python3 chip_smoke.py`` from the root of ``OTHER_DIR`` (for
example the parent commit unpacked by ``git archive`` into a directory
that ``.gitignore`` lists), then from this checkout, each in its own
process, and prints each one's exit code and wall seconds on the host
clock, so that two versions of the script compare on one card in one
call. With test files after it, it then runs them with ``python3 -m
pytest -m cuda --noconftest`` (the card tests). The full outputs go to
``build/ab/other.log``, ``build/ab/this.log`` and
``build/ab/card_tests.log``; the summary is the last lines. Exits
non-zero if any of them failed.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "ab"


def run(name: str, cmd: list, cwd: Path) -> int:
    log = OUT / f"{name}.log"
    t = time.perf_counter()
    with open(log, "w") as fh:
        rc = subprocess.run(cmd, cwd=cwd, stdout=fh, stderr=subprocess.STDOUT).returncode
    s = time.perf_counter() - t
    tail = log.read_text().splitlines()[-1:] or [""]
    print(f"{name}: exit {rc} in {s:.1f} s; last line: {tail[0][:200]}", flush=True)
    return rc


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other, tests = Path(sys.argv[1]).resolve(), sys.argv[2:]
    OUT.mkdir(parents=True, exist_ok=True)
    rcs = [run("other", [sys.executable, "chip_smoke.py"], other),
           run("this", [sys.executable, "chip_smoke.py"], ROOT)]
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
