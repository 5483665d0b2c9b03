"""Time ``chip_smoke.py`` of another checkout and of this one in one call.

    python3 chip_ab.py OTHER_DIR [--no-smoke] [--pairs N KEYS] [--obs-pairs N] [--sass]
                       [CARD_TESTS ...]

Runs ``python3 chip_smoke.py`` from the root of ``OTHER_DIR`` (for
example the parent commit unpacked by ``git archive`` into a directory
that ``.gitignore`` lists), then from this checkout, each in its own
process, and prints each one's exit code and wall seconds on the host
clock, so that two versions of the script compare on one card in one
call. ``--pairs N KEYS`` (KEYS comma-separated model keys, e.g.
``raft,kvchaos,raftlog``) then times those libraries' kernels in
alternating pairs, N runs of ``chip_smoke.py --groups 8 KEYS`` on each
side in the order other, this, this, other, ..., and prints each side's
per-run medians and their spread per library. ``--obs-pairs N`` times
raft at its bench shape with every observability tap on (metrics,
coverage with hit counts, a 256-row ring) and the causal axis off, N
runs a side in the same alternating order, each in its own process
importing that side's package, and prints each side's medians. After
the two ``chip_smoke.py`` runs it holds this side's kernels without the
taps to the other's: each library without latency markers that both
sides build must have the same registers for its run kernels without
the taps and its drain kernel, and the same launch shape (shared bytes
and blocks per SM) at every pool; the libraries with markers, which
carry the client-retry timers, are printed where they differ.
``--no-smoke`` leaves out the two ``chip_smoke.py`` runs and that
comparison. ``--sass`` builds every registered library on both sides
and compares each one's machine code (``cuobjdump -sass``), every line
but the kernels' names and the symbols instructions name, which carry
the unit's anonymous namespace and the trait's template arguments. With test files after it, it then runs them with ``python3 -m pytest -m cuda --noconftest``
(the card tests). The full outputs go to ``build/ab/other.log``,
``build/ab/this.log``, ``build/ab/pair_<side>_<i>.log`` and
``build/ab/card_tests.log``; the summary is the last lines. Exits
non-zero if any of them failed. Both sides' ``[time]`` lines close the summary.
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
# chip_smoke.py phase 2: a library's line, its kernels' resource lines
# and its launch shape at each pool
LIB_LINE = re.compile(r"^  (\S+): \S*libmadsim_\S+\.so$")
FN_LINE = re.compile(r"Function properties for \S*?((?:run|drain)_kernel\S*)")
REG_LINE = re.compile(r"Used (\d+) registers")
POOL_LINE = re.compile(r"^    (pool \d+: .*)$")
# raft at its bench shape with every tap and the causal axis off, timed
# by CUDA events in a process that imports the side's package
OBS_SCRIPT = r"""
import statistics, sys
import numpy as np, torch
sys.path.insert(0, ".")
from madsim_tpu_torch.engine import EngineConfig, make_init, make_run_while
from madsim_tpu_torch.models import BENCH_SPECS
factory, kw, n, cap = BENCH_SPECS["raft"]
wl, cfg = factory(), EngineConfig(**kw)
taps = dict(metrics=True, cov_words=64, cov_hitcount=True, timeline_cap=256)
st = make_init(wl, cfg, device="cuda", **taps)(np.arange(n, dtype=np.uint64))
run = make_run_while(wl, cfg, cap, **taps)
run(st)
ms = []
for _ in range(7):
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    run(st)
    b.record()
    torch.cuda.synchronize()
    ms.append(a.elapsed_time(b))
print(f"obs raft: median {statistics.median(ms):.4f} ms, all {[round(x, 4) for x in ms]}")
"""
OBS_LINE = re.compile(r"^obs raft: median ([0-9.]+) ms")


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


def obs_pairs(other: Path, n: int) -> list:
    """``n`` alternating timing runs a side of raft with every tap and the
    axis off; prints each side's medians. Returns the exit codes."""
    sides = {"other": other, "this": ROOT}
    medians = {side: [] for side in sides}
    rcs = []
    for i in range(n):
        for side in (("other", "this") if i % 2 == 0 else ("this", "other")):
            name = f"obs_{side}_{i}"
            rcs.append(run(name, [sys.executable, "-c", OBS_SCRIPT], sides[side]))
            for line in (OUT / f"{name}.log").read_text().splitlines():
                m = OBS_LINE.match(line)
                if m:
                    medians[side].append(float(m.group(1)))
    for side, ms in medians.items():
        if ms:
            print(f"obs-pairs raft {side}: medians {ms}; median {statistics.median(ms):.4f} ms, "
                  f"spread {min(ms):.4f}..{max(ms):.4f}", flush=True)
    return rcs


def base_kernels(log: Path) -> dict:
    """Phase 2 of a chip_smoke.py log: ``{(library, kernel): registers}``
    for the kernels without the taps, and ``{(library, pool line): text}``
    for the launch shapes."""
    out, lib, fn = {}, None, None
    for line in log.read_text().splitlines():
        m = LIB_LINE.match(line)
        if m:
            lib, fn = m.group(1), None
            continue
        if lib is None:
            continue
        m = FN_LINE.search(line)
        if m:
            fn = m.group(1)
            continue
        m = REG_LINE.search(line)
        if m and fn is not None:
            # the taps' kernels are run_kernel<E, MET, true>: ...ELb1EEEv
            if not re.match(r"run_kernelILi\d+ELb\dELb1E", fn):
                out[lib, fn] = int(m.group(1))
            fn = None
            continue
        m = POOL_LINE.match(line)
        if m:
            out[lib, m.group(1).split(":")[0]] = m.group(1)
        elif line.startswith("["):
            lib = None
    return out


def compare_base_kernels() -> int:
    """0 when every library without latency markers that both logs built
    has this side's kernels without the taps equal to the other's
    (registers, launch shape). The libraries with markers are compared
    and their differences printed, not held."""
    sys.path.insert(0, str(ROOT))
    from madsim_tpu_torch.engine.fused import MODELS

    marked = {key for key, m in MODELS.items() if m.lat}
    other, this = base_kernels(OUT / "other.log"), base_kernels(OUT / "this.log")
    both = sorted(set(other) & set(this))
    held = [k for k in both if k[0] not in marked]
    bad = [k for k in held if other[k] != this[k]]
    moved = [k for k in both if k[0] in marked and other[k] != this[k]]
    libs = sorted({k[0] for k in held})
    print(f"kernels without the taps: {len(held)} registers and launch shapes of {len(libs)} "
          f"libraries without markers compared, {len(bad)} differ" + (f": {bad}" if bad else ""),
          flush=True)
    for k in bad:
        print(f"  {k}: other {other[k]}, this {this[k]}", flush=True)
    print(f"libraries with markers: {len(both) - len(held)} compared, {len(moved)} differ",
          flush=True)
    for k in moved:
        print(f"  {k}: other {other[k]}, this {this[k]}", flush=True)
    return 1 if bad or not held else 0


# each side's registered libraries, built (or found) by its own package
BUILD_ALL = ("import sys; sys.path.insert(0, '.'); "
             "from madsim_tpu_torch.engine.fused import MODELS, build_libraries; "
             "r = build_libraries(list(MODELS.values())); "
             "print('\\n'.join(f'LIB {k} {p}' for k, (p, _l) in r.items()))")
# a kernel's name line in cuobjdump -sass, and the unit's path lines;
# a symbol an instruction names
SASS_NAME = re.compile(r"Function : |identifier|\.cu\b")
SASS_SYMBOL = re.compile(r"`\([^)]*\)")


def sass_lines(path: Path) -> list:
    """A library's machine code, every line but the kernels' names and the
    unit's path, with the symbols instructions name left out."""
    text = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    return [SASS_SYMBOL.sub("`(symbol)", line) for line in text.splitlines()
            if not SASS_NAME.search(line)]


def compare_sass(other: Path) -> int:
    """0 when every registered library that both sides build has the same
    machine code but for its kernels' names."""
    libs = {}
    for side, root in (("other", other), ("this", ROOT)):
        out = subprocess.run([sys.executable, "-c", BUILD_ALL], cwd=root, capture_output=True,
                             text=True, check=True).stdout
        libs[side] = {line.split()[1]: Path(line.split()[2]) for line in out.splitlines()
                      if line.startswith("LIB ")}
    both = sorted(set(libs["other"]) & set(libs["this"]))
    bad = []
    for key in both:
        a, b = sass_lines(libs["other"][key]), sass_lines(libs["this"][key])
        if a != b:
            bad.append(key)
        print(f"sass {key}: {'equal' if a == b else 'DIFFER'} ({len(b)} lines, "
              f"{sum(1 for x, y in zip(a, b) if x != y)} differ)", flush=True)
    print(f"sass: {len(both) - len(bad)} of {len(both)} libraries equal but for the "
          f"kernels' names" + (f"; differ: {bad}" if bad else ""), flush=True)
    return 1 if bad or not both else 0


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other, rest = Path(sys.argv[1]).resolve(), sys.argv[2:]
    n_pairs, keys, n_obs, smoke, sass = 0, "", 0, True, False
    while rest[:1] and rest[0].startswith("--"):
        flag, rest = rest[0], rest[1:]
        if flag == "--pairs":
            n_pairs, keys, rest = int(rest[0]), rest[1], rest[2:]
        elif flag == "--obs-pairs":
            n_obs, rest = int(rest[0]), rest[1:]
        elif flag == "--no-smoke":
            smoke = False
        elif flag == "--sass":
            sass = True
        else:
            print(__doc__, file=sys.stderr)
            return 2
    tests = rest
    OUT.mkdir(parents=True, exist_ok=True)
    rcs = []
    if smoke:
        rcs += [run("other", [sys.executable, "chip_smoke.py"], other),
                run("this", [sys.executable, "chip_smoke.py"], ROOT)]
        rcs.append(compare_base_kernels())
    if n_pairs:
        rcs += pairs(other, n_pairs, keys)
    if n_obs:
        rcs += obs_pairs(other, n_obs)
    if sass:
        rcs.append(compare_sass(other))
    if tests:
        rcs.append(run("card_tests", [sys.executable, "-m", "pytest", "-m", "cuda",
                                      "--noconftest", "-q", "-p", "no:cacheprovider", *tests],
                       ROOT))
    for side in ("other", "this") if smoke else ():
        for line in (OUT / f"{side}.log").read_text().splitlines():
            if line.startswith("[time]"):
                print(f"{side} {line}")
    return 0 if not any(rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
