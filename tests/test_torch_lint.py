"""madsim_tpu_torch.lint's AST rules against the JAX package's: the same
findings (rule, line, column) on every fixture of ``tests/test_lint.py``'s
rule tests, with the sim-code rules on and off; the port lints clean with
every pragma used; the sim-code test matches the port's paths; and the
command line's exit codes."""

import _torch_threads  # noqa: F401
import json
import subprocess
import sys
from pathlib import Path

import pytest

from madsim_tpu.lint.rules import lint_source as j_lint_source
from madsim_tpu_torch.lint import rules as trules

ROOT = Path(__file__).resolve().parent.parent

# every fixture of tests/test_lint.py::TestLintRules, in its order
SNIPPETS = (
    "import time\nseed = int(time.time_ns())\n",
    "from datetime import datetime\nx = datetime.now()\n",
    "import time as t\nx = t.perf_counter()\n",
    "import os\nx = os.urandom(8)\n",
    "import secrets\nx = secrets.token_bytes(4)\n",
    "import os.path\nx = os.urandom(8)\n",
    "import xml.etree\nimport time\nt = time.time()\n",
    "def f(:\n",
    "import uuid\nu = uuid.uuid4()\n",
    "import uuid\nu = uuid.uuid5(uuid.NAMESPACE_DNS, 'x')\n",
    "import numpy as np\nx = np.random.rand(3)\n",
    "import numpy as np\ng = np.random.default_rng(7)\n",
    "import numpy as np\ng = np.random.default_rng()\n",
    "for x in set([1, 2]):\n    pass\n",
    "xs = list({1, 2} | {3})\n",
    "xs = [y for y in frozenset((1, 2))]\n",
    "xs = sorted(set([3, 1]))\n",
    "for k in {'a': 1}:\n    pass\n",
    "def f(a, b):\n    if id(a) < id(b):\n        return a\n",
    "x = 1 if hash('k') % 2 else 2\n",
    "k = id(object())\n",
    "import jax\nk = jax.random.PRNGKey(0)\n",
    "import jax\nk = jax.random.PRNGKey(seed)\n",
    "from jax import random as jr\nk = jr.key(42)\n",
    "import jax\nk = jax.random.PRNGKey(0)  # lint: allow(fixed-key)\n",
    "from jax.experimental import io_callback\n"
    "def f(x):\n    return io_callback(print, None, x)\n",
    "import jax\njax.debug.print('{}', 1)\n",
    "import time\nt0 = time.monotonic()  # lint: allow(wall-clock)\n"
    "# lint: allow(wall-clock)\nt1 = time.monotonic()\n",
    "x = 1  # lint: allow(np-random)\n",
    "import time\nt0 = time.monotonic()  # lint: allow(wall-clock)\n"
    "x = 1  # lint: allow(wall-clock)\n",
    "import os\nx = os.urandom(4)  # lint: allow(wall-clock)\n",
)


def _key(result):
    return (sorted((f.rule, f.line, f.col) for f in result.findings),
            sorted((f.rule, f.line, f.col) for f in result.allowed))


@pytest.mark.parametrize("sim_code", [True, False], ids=["sim", "host"])
@pytest.mark.parametrize("idx", range(len(SNIPPETS)))
def test_rules_find_what_the_jax_package_finds(idx, sim_code):
    src = SNIPPETS[idx]
    want = j_lint_source(src, "fx.py", sim_code=sim_code)
    got = trules.lint_source(src, "fx.py", sim_code=sim_code)
    assert _key(got) == _key(want)
    assert [f.message for f in got.findings] == [f.message for f in want.findings]


def test_the_port_lints_clean_with_every_pragma_used():
    res = trules.lint_repo()
    assert res.n_files > 50
    assert res.ok, "\n".join(str(f) for f in res.findings)
    # the checked allowlist: the port's telemetry walls, all of them live,
    # and the single-seed runtime's two sites, the JAX package's own: the
    # builder's default seed from real entropy and as_completed's dedup
    walls = [f for f in res.allowed if f.rule == "wall-clock"]
    others = sorted((f.rule, f.path) for f in res.allowed if f.rule != "wall-clock")
    assert others == [("ambient-entropy", "madsim_tpu_torch/runtime/builder.py"),
                      ("id-hash-branch", "madsim_tpu_torch/runtime/aio.py")]
    assert len(walls) == len(res.allowed) - 2 >= 30
    # the real backend's and the dual seam's wall clocks, the JAX
    # package's own pragmas, each site by name
    layers = ("madsim_tpu_torch/std/", "madsim_tpu_torch/services/",
              "madsim_tpu_torch/compat/", "madsim_tpu_torch/sync.py")
    assert sorted((Path(f.path).as_posix(), f.line) for f in walls
                  if Path(f.path).as_posix().startswith(layers)) == [
        ("madsim_tpu_torch/services/_dual.py", 62),
        ("madsim_tpu_torch/std/time.py", 24),
        ("madsim_tpu_torch/std/time.py", 35),
        ("madsim_tpu_torch/std/time.py", 39),
    ]
    assert {Path(f.path).parts[0] for f in res.allowed} == {"madsim_tpu_torch"}


def test_the_default_surface_is_the_port():
    assert trules.DEFAULT_PATHS == ("madsim_tpu_torch",)
    assert trules.is_sim_code("madsim_tpu_torch/engine/core.py")
    assert trules.is_sim_code(ROOT / "madsim_tpu_torch" / "models" / "raft.py")
    assert not trules.is_sim_code("madsim_tpu/engine/core.py")
    assert not trules.is_sim_code("chip_smoke.py")
    # the sim-code rules fire in the port's files through lint_paths
    src = "import jax\nk = jax.random.PRNGKey(0)\n"
    assert [f.rule for f in trules.lint_source(src, "m.py", sim_code=True).findings] \
        == ["fixed-key"]


def test_sim_code_rules_apply_under_the_port_directory(tmp_path):
    pkg = tmp_path / "madsim_tpu_torch" / "engine"
    pkg.mkdir(parents=True)
    (pkg / "leak.py").write_text("import jax\nk = jax.random.PRNGKey(0)\n")
    (tmp_path / "tool.py").write_text("import jax\nk = jax.random.PRNGKey(0)\n")
    res = trules.lint_paths([tmp_path], root=tmp_path)
    assert [(f.rule, f.path) for f in res.findings] == [
        ("fixed-key", str(Path("madsim_tpu_torch") / "engine" / "leak.py"))]


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "madsim_tpu_torch.lint", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_cli_exits_0_on_the_port_and_1_on_a_dirty_file(tmp_path):
    out = _cli("--format", "json")
    assert out.returncode == 0, out.stdout + out.stderr
    doc = json.loads(out.stdout)
    assert doc["findings"] == [] and doc["n_files"] > 50 and doc["allowed"]
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import time\nseed = time.time()\nx = 1  # lint: allow(np-random)\n")
    out = _cli("--format", "json", str(dirty))
    assert out.returncode == 1
    rules = sorted(f["rule"] for f in json.loads(out.stdout)["findings"])
    assert rules == ["unused-allow", "wall-clock"]
