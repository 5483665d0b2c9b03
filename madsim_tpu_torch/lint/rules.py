"""Nondeterminism-leak linter: AST rules over sim code.

Port of ``madsim_tpu/lint/rules.py``, its rules unchanged, pointed at the
port: the default surface is ``madsim_tpu_torch/`` and the sim-code
rules (``host-callback``, ``fixed-key``) apply to files under a
``madsim_tpu_torch`` package directory. ``chip_smoke.py`` and
``chip_ab.py`` stay off the default surface: they are measurement
drivers made of wall-clock reads around card work (some seventy of
them), never sim code, and feed no deterministic artifact.

The runtime interposition layer (runtime/intercept.py) makes *patched*
stdlib entry points deterministic inside a simulation — but it openly
admits bypasses (``datetime.datetime.now`` reads the clock in C), and
it can do nothing about code that runs OUTSIDE a sim context yet feeds
deterministic artifacts: a soak tool seeding from the wall clock, a
plan compiler iterating a ``set``, a handler calling ``id()`` in a
branch. This module turns the convention into a checked invariant: a
small, alias-aware AST pass with one rule per leak class.

Rules (each Finding carries the rule name):

* ``wall-clock``      — wall/monotonic clock reads (``time.time``,
  ``time.time_ns``, ``time.monotonic*``, ``time.perf_counter*``,
  ``datetime.datetime.now/utcnow/today``, ``datetime.date.today``).
  Telemetry wall timers are legitimate — annotate them.
* ``ambient-entropy`` — ``os.urandom``, ``os.getrandom``,
  ``secrets.*``, ``random.SystemRandom`` (entropy the threefry
  discipline never sees).
* ``uuid-entropy``    — ``uuid.uuid1``/``uuid.uuid4`` (MAC/clock and
  ambient entropy respectively; uuid3/5 are pure functions).
* ``np-random``       — the un-threefry'd numpy RNG: any
  ``numpy.random.*`` call (``default_rng``/``RandomState``/
  ``SeedSequence`` with an explicit seed argument are allowed — those
  are deterministic constructions).
* ``unordered-iter``  — a set-typed expression in an ordering-
  sensitive position: iterated by ``for``/comprehensions, or
  materialized via ``list``/``tuple``/``enumerate``/``iter``/
  ``.join`` without ``sorted``. Set iteration order is salted per
  process; feeding it into emits or plan compilation is a schedule
  leak. (dict preserves insertion order in py>=3.7 and is not
  flagged.)
* ``id-hash-branch``  — ``id()`` / object-``hash()`` inside a branch
  condition (``if``/``while``/ternary/``assert``): memory addresses
  and salted hashes must never steer control flow in sim code.
* ``host-callback``   — ``io_callback`` / ``pure_callback`` /
  ``jax.debug.callback`` / ``jax.debug.print`` in sim code: a host
  round-trip inside a jitted step breaks both determinism (host
  effects are unordered across devices) and the never-move-state-
  to-host discipline.
* ``fixed-key``       — ``jax.random.PRNGKey``/``jax.random.key`` with
  a literal constant seed in library (sim) code: the repo's RNG
  discipline is counter-based threefry keyed by the INSTANCE seed
  (engine/rng.py); a hard-coded ``PRNGKey(0)`` silently correlates
  "independent" draws across every seed in a batch and across every
  call site sharing the constant. Derive keys from the instance seed
  (or annotate a deliberately-fixed key).

Pragmas: append ``# lint: allow(rule)`` (comma-separate several rules)
to the offending line — or put it on a comment line directly above —
to allowlist an intentional site. The allowlist is CHECKED: a pragma
that suppressed nothing becomes an ``unused-allow`` finding, so stale
annotations cannot accumulate.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path

__all__ = [
    "DEFAULT_PATHS",
    "Finding",
    "LintResult",
    "RULES",
    "is_sim_code",
    "lint_paths",
    "lint_repo",
    "lint_source",
]

RULES = (
    "wall-clock",
    "ambient-entropy",
    "uuid-entropy",
    "np-random",
    "unordered-iter",
    "id-hash-branch",
    "host-callback",
    "fixed-key",
    "unused-allow",
    "parse-error",
)

# the default lint surface: the port's package
DEFAULT_PATHS = ("madsim_tpu_torch",)

_PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\(([^)]*)\)")

_WALL_CLOCK = {
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.clock_gettime",
    "time.clock_gettime_ns",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
    "datetime.datetime.today",
    "datetime.date.today",
}

_ENTROPY = {
    "os.urandom",
    "os.getrandom",
    "random.SystemRandom",
}

_UUID = {"uuid.uuid1", "uuid.uuid4"}

_SEEDED_NP = {"default_rng", "RandomState", "SeedSequence", "Generator"}

_HOST_CB = {
    "jax.experimental.io_callback",
    "jax.pure_callback",
    "jax.debug.callback",
    "jax.debug.print",
    "jax.experimental.host_callback.call",
}

# key constructors whose literal-constant seeds the fixed-key rule flags
_JAX_KEY = {"jax.random.PRNGKey", "jax.random.key"}
# bare suffixes that identify the same callables when imported directly
# (``from jax.experimental import io_callback``)
_HOST_CB_SUFFIX = {"io_callback", "pure_callback"}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    snippet: str = ""

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LintResult:
    findings: list  # list[Finding] — violations (incl. unused-allow)
    allowed: list  # list[Finding] — suppressed by a pragma (the
    #                checked allowlist inventory)
    n_files: int = 0

    @property
    def ok(self) -> bool:
        return not self.findings

    def merge(self, other: "LintResult") -> None:
        self.findings.extend(other.findings)
        self.allowed.extend(other.allowed)
        self.n_files += other.n_files


class _Aliases:
    """Import-alias resolution: dotted names back to canonical roots."""

    def __init__(self):
        self.map: dict = {}

    def visit_imports(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.map[a.asname] = a.name
                    else:
                        # ``import os.path`` binds the local name
                        # ``os`` to the ROOT module — mapping it to
                        # the dotted name would mis-resolve a later
                        # ``os.urandom`` to ``os.path.urandom`` and
                        # silently disable every call rule on that root
                        root = a.name.split(".")[0]
                        self.map[root] = root
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    self.map[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> str | None:
        """Dotted canonical name of a Name/Attribute chain, or None."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.map.get(node.id, node.id)
        parts.append(root)
        name = ".".join(reversed(parts))
        # normalize the common numpy alias once resolved
        if name == "np" or name.startswith("np."):
            name = "numpy" + name[2:]
        return name


def _is_set_expr(node: ast.AST) -> bool:
    """Syntactically set-typed: a set display/comprehension or a
    ``set(...)``/``frozenset(...)`` call (including methods returning
    sets: ``.union``/``.intersection``/``.difference`` on one)."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
            return True
        if isinstance(f, ast.Attribute) and f.attr in (
            "union", "intersection", "difference", "symmetric_difference",
        ):
            return _is_set_expr(f.value)
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
    ):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, aliases: _Aliases, sim_code: bool):
        self.path = path
        self.aliases = aliases
        self.sim_code = sim_code  # host-callback rule scope
        self.found: list = []
        self._branch_depth = 0

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        self.found.append(
            Finding(
                rule=rule,
                path=self.path,
                line=getattr(node, "lineno", 0),
                col=getattr(node, "col_offset", 0),
                message=msg,
            )
        )

    # -- calls ----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = self.aliases.resolve(node.func)
        if name:
            self._check_call(name, node)
        # ordering-sensitive materialization of a set
        if isinstance(node.func, ast.Name) and node.func.id in (
            "list", "tuple", "enumerate", "iter",
        ):
            if node.args and _is_set_expr(node.args[0]):
                self._emit(
                    "unordered-iter",
                    node,
                    f"{node.func.id}() over a set materializes the "
                    f"process-salted iteration order; wrap in sorted()",
                )
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "join"
            and node.args
            and _is_set_expr(node.args[0])
        ):
            self._emit(
                "unordered-iter",
                node,
                "str.join over a set depends on the salted iteration "
                "order; wrap in sorted()",
            )
        self.generic_visit(node)

    def _check_call(self, name: str, node: ast.Call) -> None:
        if name in _WALL_CLOCK:
            self._emit(
                "wall-clock",
                node,
                f"{name}() bypasses the determinism substrate outside a "
                f"sim context (intercept.py patches it only in-sim); "
                f"annotate telemetry walls with a pragma",
            )
        elif name in _ENTROPY or name.startswith("secrets."):
            self._emit(
                "ambient-entropy",
                node,
                f"{name}() draws ambient entropy the threefry discipline "
                f"never sees",
            )
        elif name in _UUID:
            self._emit(
                "uuid-entropy",
                node,
                f"{name}() is clock/entropy-derived; use uuid3/uuid5 "
                f"over deterministic inputs or a seeded stream",
            )
        elif name.startswith("numpy.random."):
            leaf = name.rsplit(".", 1)[1]
            if not (leaf in _SEEDED_NP and (node.args or node.keywords)):
                self._emit(
                    "np-random",
                    node,
                    f"{name}() is the un-threefry'd numpy RNG; draw "
                    f"through engine.rng / np_threefry2x32 or seed an "
                    f"explicit Generator",
                )
        elif self.sim_code and (
            name in _HOST_CB or name.rsplit(".", 1)[-1] in _HOST_CB_SUFFIX
        ):
            self._emit(
                "host-callback",
                node,
                f"{name}() is a host round-trip inside sim code: host "
                f"effects are unordered across devices and break the "
                f"device-resident discipline",
            )
        elif (
            self.sim_code
            and name in _JAX_KEY
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            self._emit(
                "fixed-key",
                node,
                f"{name}({node.args[0].value!r}) hard-codes an RNG key "
                f"in library code: every batch row (and every call "
                f"site sharing the constant) draws the SAME stream — "
                f"derive the key from the instance seed "
                f"(engine/rng.py), or annotate a deliberately-fixed "
                f"key",
            )

    # -- unordered iteration -------------------------------------------
    def visit_For(self, node: ast.For) -> None:
        if _is_set_expr(node.iter):
            self._emit(
                "unordered-iter",
                node.iter,
                "iterating a set: order is process-salted; wrap in "
                "sorted()",
            )
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        if _is_set_expr(node.iter):
            self._emit(
                "unordered-iter",
                node.iter,
                "comprehension over a set: order is process-salted; "
                "wrap in sorted()",
            )
        self.generic_visit(node)

    # -- id()/hash() in branch conditions -------------------------------
    def _scan_branch(self, test: ast.AST) -> None:
        for sub in ast.walk(test):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Name)
                and sub.func.id in ("id", "hash")
            ):
                self._emit(
                    "id-hash-branch",
                    sub,
                    f"{sub.func.id}() in a branch condition: memory "
                    f"addresses / salted hashes must not steer sim "
                    f"control flow",
                )

    def visit_If(self, node: ast.If) -> None:
        self._scan_branch(node.test)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._scan_branch(node.test)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._scan_branch(node.test)
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._scan_branch(node.test)
        self.generic_visit(node)


def _pragma_entries(source: str) -> list:
    """One entry per ``# lint: allow(...)`` comment:
    ``{"anchor": line, "rules": set, "covers": set}``.

    A trailing pragma covers exactly its own line; a pragma on a
    comment-only line covers exactly the next line (annotation-above
    style). Each pragma's usage is tracked INDIVIDUALLY so a dead
    pragma next to a live same-rule one is still reported stale.
    """
    entries: list = []
    lines = source.splitlines()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if not m:
                continue
            rules = {
                r.strip() for r in m.group(1).split(",") if r.strip()
            }
            line = tok.start[0]
            # comment-only line: the token starts at the line's first
            # non-whitespace column
            src_line = lines[line - 1] if line <= len(lines) else ""
            covers = (
                {line + 1} if src_line.lstrip().startswith("#") else {line}
            )
            entries.append(
                {"anchor": line, "rules": rules, "covers": covers}
            )
    except tokenize.TokenError:
        pass
    return entries


def lint_source(
    source: str, path: str = "<string>", sim_code: bool = True
) -> LintResult:
    """Lint one module's source text."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return LintResult(
            findings=[
                Finding(
                    rule="parse-error",
                    path=path,
                    line=exc.lineno or 0,
                    col=exc.offset or 0,
                    message=f"unparseable: {exc.msg}",
                )
            ],
            allowed=[],
            n_files=1,
        )
    aliases = _Aliases()
    aliases.visit_imports(tree)
    visitor = _Visitor(path, aliases, sim_code)
    visitor.visit(tree)

    pragmas = _pragma_entries(source)
    lines = source.splitlines()
    findings, allowed = [], []
    for f in visitor.found:
        snippet = lines[f.line - 1].strip() if 0 < f.line <= len(lines) else ""
        f = dataclasses.replace(f, snippet=snippet)
        suppressed = False
        for p in pragmas:
            if f.line in p["covers"] and f.rule in p["rules"]:
                p.setdefault("used", set()).add(f.rule)
                suppressed = True
        if suppressed:
            allowed.append(f)
        else:
            findings.append(f)
    # the checked allowlist: every pragma must suppress something —
    # per pragma, not per line, so a dead pragma adjacent to a live
    # same-rule one is still reported. ``absint-*`` rules belong to the
    # jaxpr interval prover (lint.absint): their staleness is judged
    # against traced programs, not this AST pass — see
    # ``absint.stale_absint_pragmas``, run by the same repo gates.
    for p in pragmas:
        stale = {
            r for r in p["rules"] - p.get("used", set())
            if not r.startswith("absint-")
        }
        if not stale:
            continue
        findings.append(
            Finding(
                rule="unused-allow",
                path=path,
                line=p["anchor"],
                col=0,
                message=(
                    f"pragma allows {sorted(stale)} but suppresses no "
                    f"such finding — stale allowlist entry"
                ),
                snippet=(
                    lines[p["anchor"] - 1].strip()
                    if p["anchor"] <= len(lines)
                    else ""
                ),
            )
        )
    return LintResult(findings=findings, allowed=allowed, n_files=1)


def _iter_py_files(paths) -> list:
    out = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py" and p.exists():
            out.append(p)
    return [p for p in out if "__pycache__" not in p.parts]


def is_sim_code(path) -> bool:
    """Whether the sim-code rules apply to ``path``: it lies under a
    ``madsim_tpu_torch`` package directory."""
    return "madsim_tpu_torch" in Path(path).parts


def lint_paths(paths, root: str | None = None) -> LintResult:
    """Lint every ``*.py`` under the given files/directories.

    The ``host-callback`` and ``fixed-key`` rules apply only to sim code
    — files under a ``madsim_tpu_torch`` package directory; drivers and
    tools run host-side by definition.
    """
    result = LintResult(findings=[], allowed=[], n_files=0)
    rootp = Path(root) if root else None
    for file in _iter_py_files(paths):
        rel = str(file.relative_to(rootp)) if rootp else str(file)
        sim_code = is_sim_code(rel)
        result.merge(
            lint_source(
                file.read_text(encoding="utf-8"), rel, sim_code=sim_code
            )
        )
    return result


def lint_repo(root: str | None = None) -> LintResult:
    """Lint the default surface (DEFAULT_PATHS) relative to ``root``
    (default: the repository containing this package)."""
    base = Path(root) if root else Path(__file__).resolve().parents[2]
    return lint_paths(
        [base / p for p in DEFAULT_PATHS if (base / p).exists()], root=base
    )
