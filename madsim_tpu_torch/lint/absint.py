"""The useful part of the JAX package's interval prover, on the port.

Port of the lane half of ``madsim_tpu/lint/absint.py`` and of the
guarantee half of its column contracts. The JAX prover walks traced
jaxprs; the port has no graph to walk (its step is eager torch and its
run kernel CUDA), so both checks here read what the port does have:

* **The lane registry check** (:func:`check_lanes`). Every threefry
  draw site of the port — each call of ``engine/rng.py``'s ``Draw``
  methods and of ``threefry2x32`` (and its numpy twins) under
  ``engine/``, ``models/``, ``chaos/``, ``explore/`` and ``farm/`` — is
  found by an AST scan (:func:`scan_draw_sites`), and its purpose
  expression is resolved to the ``PURPOSE_*`` lanes it names
  (``engine/rng.py`` ``PURPOSE_LANES``): through module constants,
  local and closure assignments, list building, ``self`` attributes and
  a parameter's default and call sites. Three obligations follow:

  1. every site resolves to a registered lane (each resolved purpose
     goes through :func:`check_lane_site`, the JAX package's
     obligations (a) and (b) over one site);
  2. the lane's owner fits the file that names it: engine lanes in
     ``engine/`` (which also draws the user lane, for the handlers'
     declared ``draw_purposes``, in the step's batched block), the user
     lane in ``models/``, plan and client in ``chaos/``, explore in
     ``explore/``, farm in ``farm/``;
  3. each model's ``draw_purposes`` are distinct and inside the user
     lane.

  The run kernel's constants (``csrc/engine_step.cuh``) are held equal
  to the registry's bases too. The JAX prover's third obligation, that
  two live sites never share a purpose at overlapping counters, needs a
  traced program's counter ranges and its ``cond`` branch structure
  (the JAX prover's branch exclusivity, ``absint.py:240``), which has no
  counterpart here: the batched plain step computes every handler's
  draws under masks and uses only the dispatched handler's, so
  same-purpose sites in sibling handlers are not a collision, and an
  AST scan cannot tell two sites of one dispatch from two of sibling
  handlers. Each site is checked alone, so the JAX package's pairwise
  code is not copied.

* **The range guarantee** (:func:`check_ranges`): a state at a chunk
  boundary holds every column within its ``engine.column_contracts``
  contract. Seeds whose ``now`` has passed the certification horizon
  are reported as uncertified, not as findings.

The JAX package's overflow prover is not ported: it certifies the
``time32`` lowering, which the port's one-lowering rule drops.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import torch

from ..engine import rng as _rng

__all__ = [
    "LANE_RULE",
    "LaneSite",
    "RangeCheck",
    "SCAN_DIRS",
    "check_kernel_constants",
    "check_lane_site",
    "check_lanes",
    "check_model_purposes",
    "check_ranges",
    "lane_of",
    "scan_draw_sites",
    "scan_source",
]

LANE_RULE = "absint-lane"
_PKG = Path(__file__).resolve().parents[1]
# the package directories whose draw sites the scan reads
SCAN_DIRS = ("engine", "models", "chaos", "explore", "farm")
# the lane owners each directory may name
_OWNERS = {
    "engine": ("engine", "user"),
    "models": ("user",),
    "chaos": ("chaos",),
    "explore": ("explore",),
    "farm": ("farm",),
}
# Draw's methods and the position of their purpose argument; user and
# user_int take a purpose relative to the user lane's base
_DRAW_METHODS = {"bits": 0, "bits2": 0, "block2": 0, "uniform_int": 2,
                 "chance": 1, "user": 0, "user_int": 2}
_USER_METHODS = ("user", "user_int")
# the threefry entry points (the purpose is the fourth word, x1)
_THREEFRY = ("threefry2x32", "np_threefry2x32", "np_threefry2x32v")
# calls that carry their first argument's value through
_PASS_THROUGH = {"int", "uint32", "int64", "uint64", "asarray", "array", "tensor"}


def lane_of(purpose: int):
    """The registered lane containing ``purpose``, or None for
    unassigned space (the JAX package's ``engine.rng.lane_of``)."""
    for ln in _rng.PURPOSE_LANES:
        if ln.base <= purpose < ln.end:
            return ln
    return None


# ---------------------------------------------------------------------------
# Lane sites and the per-site obligations, from the JAX package's.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LaneSite:
    """One threefry application: here a scanned call site (the JAX
    package's fields; the counter range ``x0_*`` serves its pairwise
    obligation alone)."""

    path: str
    src: tuple  # (repo-relative file, line) or (None, 0)
    purposes: object  # exact np.ndarray of purpose words, or None
    p_lo: int
    p_hi: int
    x0_lo: int
    x0_hi: int
    x0_tags: tuple

    def describe(self) -> str:
        if self.purposes is not None:
            vals = sorted(int(v) for v in np.unique(self.purposes))
            shown = ", ".join(f"{v:#x}" for v in vals[:8])
            if len(vals) > 8:
                shown += f", ... ({len(vals)} lanes)"
            p = f"purposes {{{shown}}}"
        else:
            p = f"purposes [{self.p_lo:#x}, {self.p_hi:#x}]"
        where = f"{self.src[0]}:{self.src[1]}" if self.src[0] else self.path
        return f"{where} {p}"

    def purpose_set(self):
        if self.purposes is None:
            return None
        return {int(v) for v in np.unique(self.purposes)}


def check_lane_site(site: LaneSite) -> list:
    """The JAX package's per-site lane obligations over one site: (a) no
    purpose drawn twice in one block, every purpose in a registered lane;
    (b) a dynamic purpose interval inside one lane. Its findings are
    those of the JAX package's ``check_lane_sites([site])``; the pairwise
    obligation has no counterpart here (module docstring)."""
    findings = []

    def _f(msg):
        findings.append(
            {
                "rule": LANE_RULE,
                "message": msg,
                "sites": [site.describe()],
                "file": site.src[0],
                "line": site.src[1],
                "paths": [site.path],
            }
        )

    pset = site.purpose_set()
    if pset is not None:
        if len(pset) != np.asarray(site.purposes).size:
            _f(
                "one site draws the same purpose twice in one block "
                "— identical cipher values, correlated lanes"
            )
        for p in pset:
            if lane_of(p) is None:
                _f(
                    f"purpose {p:#x} lies in unassigned space — "
                    f"register a PURPOSE_LANES block (engine/rng.py)"
                )
    else:
        ln_lo = lane_of(site.p_lo)
        if ln_lo is None or ln_lo is not lane_of(site.p_hi):
            _f(
                f"dynamic purpose interval [{site.p_lo:#x}, {site.p_hi:#x}] "
                f"is not contained in one registered lane — the draw "
                f"cannot be proven disjoint"
            )
    return findings


# ---------------------------------------------------------------------------
# The AST scan: draw sites and what their purpose expressions name.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Item:
    """One value a purpose expression may take: an exact purpose word
    (``purpose``), somewhere in a lane from its base up (``lane``), a
    plain integer (``int``: an offset, a mask, or a raw purpose) or
    something the scan cannot name (``dyn``). ``origin`` is where the
    lane's name or the integer appears in the source."""

    kind: str
    value: int
    origin: tuple  # (repo-relative file, line)


class _Module:
    """One parsed source file: its tree, parents, module constants and
    the names it imports from ``engine/rng.py``."""

    def __init__(self, rel: str, source: str):
        self.rel = rel
        self.tree = ast.parse(source, filename=rel)
        self.parent, self.rng_names = {}, {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
            if isinstance(node, ast.ImportFrom) and (node.module or "").endswith("rng"):
                for a in node.names:
                    self.rng_names[a.asname or a.name] = a.name
        self.globals = {}
        for node in self.tree.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.globals.setdefault(t.id, []).append(node.value)

    def scopes(self, node):
        """The functions enclosing ``node``, innermost first."""
        out = []
        while node in self.parent:
            node = self.parent[node]
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                out.append(node)
        return out

    def enclosing_class(self, node):
        while node in self.parent:
            node = self.parent[node]
            if isinstance(node, ast.ClassDef):
                return node
        return None

    def qualname(self, node) -> str:
        names = []
        while node in self.parent:
            node = self.parent[node]
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.append(node.name)
        return ".".join(reversed(names)) or "<module>"


def _params(fn) -> list:
    a = fn.args
    return [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


def _default(fn, name):
    a = fn.args
    pos = [*a.posonlyargs, *a.args]
    for x, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        if x.arg == name:
            return d
    for x, d in zip(a.kwonlyargs, a.kw_defaults):
        if x.arg == name and d is not None:
            return d
    return None


class _Resolver:
    """Resolves purpose expressions over a set of parsed modules."""

    def __init__(self, modules):
        self.modules = modules
        self._busy = set()
        # callee name -> (module, call) for every call in every module
        self.calls = {}
        for mod in modules:
            for node in mod.parent:
                if isinstance(node, ast.Call):
                    f = node.func
                    callee = f.id if isinstance(f, ast.Name) else (
                        f.attr if isinstance(f, ast.Attribute) else None)
                    if callee is not None:
                        self.calls.setdefault(callee, []).append((mod, node))

    # -- call sites of a function or class, across every module -------------
    def _call_args(self, fn, cls, param):
        """(module, expression) pairs passed for ``param`` of ``fn`` at
        its call sites (a method's ``self`` skipped; ``__init__`` is
        called by its class's name)."""
        name = cls.name if (cls is not None and fn.name == "__init__") else fn.name
        params = _params(fn)
        if params and params[0] == "self":
            params = params[1:]
        if param not in params:
            return []
        idx = params.index(param)
        out = []
        for mod, node in self.calls.get(name, ()):
            for kw in node.keywords:
                if kw.arg == param:
                    out.append((mod, kw.value))
            if idx < len(node.args) and not any(
                    isinstance(a, ast.Starred) for a in node.args[:idx + 1]):
                out.append((mod, node.args[idx]))
        return out

    # -- the resolution ------------------------------------------------------
    def resolve(self, mod, node) -> list:
        key = (mod.rel, id(node))
        if key in self._busy:
            return [_Item("dyn", 0, (mod.rel, getattr(node, "lineno", 0)))]
        self._busy.add(key)
        try:
            return self._resolve(mod, node)
        finally:
            self._busy.discard(key)

    def _resolve(self, mod, node) -> list:
        at = (mod.rel, getattr(node, "lineno", 0))
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            return [_Item("int", int(node.value), at)]
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            return [i for e in node.elts for i in self.resolve(mod, e)]
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            return self.resolve(mod, node.elt)
        if isinstance(node, ast.Name):
            return self._name(mod, node)
        if isinstance(node, ast.Attribute):
            return self._attribute(mod, node)
        if isinstance(node, ast.BinOp):
            return self._binop(mod, node)
        if isinstance(node, ast.Call):
            f = node.func
            leaf = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else None)
            if leaf in _PASS_THROUGH and node.args:
                return self.resolve(mod, node.args[0])
        return [_Item("dyn", 0, at)]

    def _name(self, mod, node) -> list:
        name = node.id
        at = (mod.rel, node.lineno)
        for fn in mod.scopes(node):
            if isinstance(fn, ast.Lambda):
                if name in [a.arg for a in fn.args.args]:
                    return [_Item("dyn", 0, at)]
                continue
            bound = self._bindings(mod, fn, name)
            if bound is not None:
                return bound
            if name in _params(fn):
                return self._param(mod, fn, name, at)
        if name in mod.rng_names:
            value = getattr(_rng, mod.rng_names[name], None)
            if isinstance(value, int):
                kind = "int" if mod.rng_names[name] == "M32" else "purpose"
                return [_Item(kind, value, at)]
        if name in mod.globals:
            return [i for v in mod.globals[name] for i in self.resolve(mod, v)]
        return [_Item("dyn", 0, at)]

    def _bindings(self, mod, fn, name):
        """The values ``name`` is bound to inside ``fn`` (its own body,
        not nested functions), or None when ``fn`` does not bind it."""
        found, hit = [], False
        stack = list(fn.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id == name:
                        hit = True
                        found += self.resolve(mod, node.value)
                    elif isinstance(t, ast.Tuple) and any(
                            isinstance(e, ast.Name) and e.id == name for e in t.elts):
                        hit = True
                        found.append(_Item("dyn", 0, (mod.rel, node.lineno)))
            elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name) \
                    and node.target.id == name:
                hit = True
                found += self.resolve(mod, node.value)
            elif isinstance(node, (ast.For, ast.comprehension)) and any(
                    isinstance(t, ast.Name) and t.id == name
                    for t in ast.walk(node.target)):
                hit = True
                found.append(_Item("dyn", 0, (mod.rel, getattr(node.target, "lineno", 0))))
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("append", "extend") \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == name and node.args:
                found += self.resolve(mod, node.args[0])
            stack.extend(ast.iter_child_nodes(node))
        return found if hit else None

    def _param(self, mod, fn, name, at) -> list:
        out = []
        d = _default(fn, name)
        if d is not None:
            out += self.resolve(mod, d)
        for m, expr in self._call_args(fn, mod.enclosing_class(fn), name):
            out += self.resolve(m, expr)
        return out or [_Item("dyn", 0, at)]

    def _attribute(self, mod, node) -> list:
        at = (mod.rel, node.lineno)
        if not (isinstance(node.value, ast.Name) and node.value.id == "self"):
            return [_Item("dyn", 0, at)]
        cls = mod.enclosing_class(node)
        if cls is None:
            return [_Item("dyn", 0, at)]
        out = []
        for sub in ast.walk(cls):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if (isinstance(t, ast.Attribute) and t.attr == node.attr
                            and isinstance(t.value, ast.Name) and t.value.id == "self"):
                        out += self.resolve(mod, sub.value)
        return out or [_Item("dyn", 0, at)]

    def _binop(self, mod, node) -> list:
        left = self.resolve(mod, node.left)
        right = self.resolve(mod, node.right)
        lanes = [i for i in left + right if i.kind in ("purpose", "lane")]
        if not lanes:
            if all(i.kind == "int" for i in left + right) and left and right:
                return [_Item("int", _apply(node.op, a.value, b.value), a.origin)
                        for a in left for b in right]
            return [i for i in left + right if i.kind == "dyn"][:1] or \
                [_Item("dyn", 0, (mod.rel, node.lineno))]
        other = right if any(i in lanes for i in left) else left
        out = []
        for it in lanes:
            if isinstance(node.op, ast.BitAnd) and all(
                    i.kind == "int" and i.value == _rng.M32 for i in other):
                out.append(it)  # masking a purpose word to 32 bits
            elif isinstance(node.op, ast.Add) and it.kind == "purpose" and len(other) == 1 \
                    and other[0].kind == "int":
                out.append(_Item("purpose", it.value + other[0].value, it.origin))
            else:
                out.append(_Item("lane", _lane_base(it.value), it.origin))
        return out


def _apply(op, a: int, b: int) -> int:
    if isinstance(op, ast.Add):
        return a + b
    if isinstance(op, ast.Sub):
        return a - b
    if isinstance(op, ast.BitAnd):
        return a & b
    if isinstance(op, ast.BitOr):
        return a | b
    if isinstance(op, ast.Mult):
        return a * b
    return a


def _lane_base(purpose: int) -> int:
    ln = lane_of(purpose)
    return ln.base if ln is not None else purpose


def _draw_call(node):
    """``(kind, purpose argument, method)`` of a draw call, or None:
    ``kind`` is "draw" for a ``Draw`` method (a call on ``draw`` or
    ``<x>.draw``) and "threefry" for a threefry entry point."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _DRAW_METHODS:
        recv = f.value
        if (isinstance(recv, ast.Name) and recv.id == "draw") or (
                isinstance(recv, ast.Attribute) and recv.attr == "draw"):
            pos = _DRAW_METHODS[f.attr]
            arg = next((k.value for k in node.keywords if k.arg == "purpose"), None)
            if arg is None and pos < len(node.args):
                arg = node.args[pos]
            return "draw", arg, f.attr
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else None)
    if name in _THREEFRY:
        arg = node.args[3] if len(node.args) > 3 else None
        return "threefry", arg, name
    return None


@dataclasses.dataclass
class _Site:
    site: LaneSite
    origin: tuple  # where the lane's name or the purpose literal appears
    method: str


def _sites_of(resolver, mod) -> tuple:
    """The draw sites of one module and the findings of purposes the
    scan cannot name."""
    sites, findings = [], []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        hit = _draw_call(node)
        if hit is None:
            continue
        kind, arg, method = hit
        src = (mod.rel, node.lineno)
        path = f"{mod.rel}:{mod.qualname(node)}"
        items = resolver.resolve(mod, arg) if arg is not None else \
            [_Item("dyn", 0, src)]
        user = kind == "draw" and method in _USER_METHODS
        for it in dict.fromkeys(items):  # one site per distinct value
            if it.kind == "dyn":
                findings.append({
                    "rule": LANE_RULE, "file": src[0], "line": src[1],
                    "message": f"{method}(): the purpose {ast.unparse(arg) if arg else '?'} "
                               f"names no PURPOSE_* lane the scan can resolve",
                    "sites": [], "paths": [path],
                })
                continue
            if it.kind == "lane":
                # somewhere in the lane from its base (the user lane for a
                # user-relative draw): the offsets are the lane's own
                ln = lane_of(_rng.PURPOSE_USER if user else it.value)
                lo, hi = (ln.base, ln.end - 1) if ln is not None else (it.value, it.value)
                s = LaneSite(path, src, None, lo, hi, 0, _rng.M32, ("counter:step",))
            else:
                value = it.value + (_rng.PURPOSE_USER if user else 0)
                s = LaneSite(path, src, np.asarray([value], np.int64), value, value,
                             0, _rng.M32, ("counter:step",))
            sites.append(_Site(s, it.origin, method))
    return sites, findings


def _parse(paths, root) -> list:
    mods = []
    for file in paths:
        rel = str(Path(file).resolve().relative_to(root))
        mods.append(_Module(rel, Path(file).read_text(encoding="utf-8")))
    return mods


def scan_source(source: str, rel: str) -> tuple:
    """Scan one source text as if it lay at ``rel`` (a path such as
    ``madsim_tpu_torch/models/x.py``); returns ``(sites, findings)`` as
    :func:`scan_draw_sites` does."""
    mod = _Module(rel, source)
    return _scan([mod], [mod])


def scan_draw_sites(root=None) -> tuple:
    """Every draw site of the port under :data:`SCAN_DIRS`, resolved:
    ``(sites, findings)`` where ``sites`` are (``LaneSite``, origin,
    method) records and ``findings`` the sites whose purpose the scan
    cannot name. Call sites are looked up across the whole package."""
    pkg = Path(root) / "madsim_tpu_torch" if root else _PKG
    base = pkg.parent
    files = sorted(p for p in pkg.rglob("*.py") if "__pycache__" not in p.parts)
    mods = _parse(files, base)
    scanned = [m for m in mods
               if Path(m.rel).parts[1:2] and Path(m.rel).parts[1] in SCAN_DIRS
               and not m.rel.endswith(str(Path("engine") / "rng.py"))]
    return _scan(mods, scanned)


def _scan(mods, scanned) -> tuple:
    resolver = _Resolver(mods)
    sites, findings = [], []
    for mod in scanned:
        s, f = _sites_of(resolver, mod)
        sites += s
        findings += f
    return sites, findings


def _owner_dir(rel: str):
    parts = Path(rel).parts
    for i, p in enumerate(parts[:-1]):
        if p == "madsim_tpu_torch" and i + 1 < len(parts) - 1:
            return parts[i + 1]
    return None


def check_sites(sites) -> list:
    """Obligations 1 and 2 over scanned sites: each resolved purpose in a
    registered lane (:func:`check_lane_site`), and
    the lane's owner fitting the directory of the file that names it."""
    findings = []
    for rec in sites:
        findings += check_lane_site(rec.site)
        ln = lane_of(rec.site.p_lo)
        where = _owner_dir(rec.origin[0])
        if ln is None or where is None:
            continue
        allowed = _OWNERS.get(where, ())
        if ln.owner not in allowed:
            findings.append({
                "rule": LANE_RULE, "file": rec.origin[0], "line": rec.origin[1],
                "message": f"lane {ln.name!r} (owner {ln.owner}) is named in {where}/, "
                           f"whose draws belong to {', '.join(allowed) or 'no'} lanes",
                "sites": [rec.site.describe()], "paths": [rec.site.path],
            })
    return findings


def check_model_purposes(workloads=None) -> list:
    """Obligation 3: each workload's ``draw_purposes`` are distinct and
    inside the user lane. ``workloads`` defaults to every family's
    default and lint-entry variants."""
    if workloads is None:
        workloads = _all_workloads()
    ulane = _rng.lane("user")
    out = []
    for wl in workloads:
        ps = [int(p) for p in (wl.draw_purposes or ())]
        if len(set(ps)) != len(ps):
            out.append({"rule": LANE_RULE, "file": None, "line": 0, "sites": [],
                        "paths": [wl.name],
                        "message": f"{wl.name}: draw_purposes {ps} repeat a purpose"})
        bad = [p for p in ps if not 0 <= p < ulane.width]
        if bad:
            out.append({"rule": LANE_RULE, "file": None, "line": 0, "sites": [],
                        "paths": [wl.name],
                        "message": f"{wl.name}: draw_purposes {bad} leave the user lane"})
    return out


def _all_workloads() -> list:
    from ..models import BENCH_SPECS, SOAK_SPECS
    from .noninterference import model_matrix

    out = [factory() for factory, *_ in (*BENCH_SPECS.values(), *SOAK_SPECS.values())]
    out += [wl for _tag, wl, _cfg, _h in model_matrix()]
    return out


_CONST_RE = re.compile(r"constexpr\s+uint32_t\s+(PURPOSE_[A-Z_]+)\s*=\s*(\d+)u?\s*;")


def check_kernel_constants(header=None) -> list:
    """The run kernel's ``PURPOSE_*`` constants (``csrc/engine_step.cuh``)
    equal the registry's: each one the header declares, by name."""
    path = Path(header) if header else _PKG / "csrc" / "engine_step.cuh"
    text = path.read_text(encoding="utf-8")
    found = dict((m.group(1), int(m.group(2))) for m in _CONST_RE.finditer(text))
    out = []
    if not found:
        out.append({"rule": LANE_RULE, "file": str(path.name), "line": 0, "sites": [],
                    "paths": [], "message": "the kernel header declares no PURPOSE_* constant"})
    for name, value in found.items():
        want = getattr(_rng, name, None)
        if want != value:
            out.append({"rule": LANE_RULE, "file": str(path.name), "line": 0, "sites": [],
                        "paths": [],
                        "message": f"kernel {name} = {value}, the registry's is {want}"})
    return out


def check_lanes(root=None) -> dict:
    """The lane registry check over the port: the scan's findings, the
    owner check, the models' purposes and the kernel's constants.
    Returns ``{"findings": [...], "sites": n, "lanes": [names]}``."""
    sites, findings = scan_draw_sites(root)
    findings = findings + check_sites(sites) + check_model_purposes() \
        + check_kernel_constants()
    lanes = sorted({lane_of(r.site.p_lo).name for r in sites if lane_of(r.site.p_lo)})
    return {"findings": findings, "sites": len(sites), "lanes": lanes}


# ---------------------------------------------------------------------------
# The range guarantee.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RangeCheck:
    """Verdict of :func:`check_ranges` on one state."""

    findings: list  # {field, lo, hi, seeds, first_seed, min, max}
    uncertified: int  # seeds past the certification horizon
    n_seeds: int

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self), "ok": self.ok}


def _bounds(contract, dtype) -> tuple:
    """The contract's range within what ``dtype`` holds, and whether
    that is the whole dtype, nothing lying outside it. A contract as
    wide as the column's word (a uint64 value in int64, by its bit
    pattern) takes the whole dtype."""
    if dtype == torch.bool:
        dlo, dhi, bits = 0, 1, 1
    else:
        info = torch.iinfo(dtype)
        dlo, dhi, bits = int(info.min), int(info.max), info.bits
    if contract.hi - contract.lo + 1 >= 1 << bits:
        return dlo, dhi, True
    lo, hi = max(contract.lo, dlo), min(contract.hi, dhi)
    return lo, hi, lo <= dlo and hi >= dhi


def check_ranges(state, contracts) -> RangeCheck:
    """Hold every non-empty column of ``state`` within its contract
    (``engine.column_contracts``), on the state's device: a value the
    column's dtype can hold outside ``[lo, hi]`` is a finding, naming
    the field, its seeds and the first one. Seeds whose ``now`` is past
    the contract of ``now`` (the certification horizon) are uncertified:
    counted, and left out of the findings."""
    s = state.seed.shape[0]
    cert = state.now <= contracts["now"].hi
    names, masks, lows, highs = [], [], [], []
    for f, c in contracts.items():
        t = getattr(state, f)
        if t.numel() == 0:
            continue
        lo, hi, whole = _bounds(c, t.dtype)
        if whole:
            continue
        v = t.to(torch.int64).reshape(s, -1)
        bad = ((v < lo) | (v > hi)).any(1) & cert
        names.append(f)
        masks.append(bad)
        lows.append(v.min(1).values)
        highs.append(v.max(1).values)
    findings = []
    if names:
        bad = torch.stack(masks)
        counts = bad.sum(1).tolist()
        first = torch.argmax(bad.to(torch.int64), dim=1).tolist()
        mins = torch.stack(lows).min(1).values.tolist()
        maxs = torch.stack(highs).max(1).values.tolist()
        for i, f in enumerate(names):
            if counts[i]:
                findings.append({"field": f, "lo": contracts[f].lo, "hi": contracts[f].hi,
                                 "seeds": int(counts[i]), "first_seed": int(first[i]),
                                 "min": int(mins[i]), "max": int(maxs[i])})
    return RangeCheck(findings, int((~cert).sum().item()), s)
