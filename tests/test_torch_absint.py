"""madsim_tpu_torch.lint.absint: the lane registry check and the range
guarantee. ``check_lane_site`` against the JAX package's
``check_lane_sites`` on each site of synthetic site lists; the AST scan
of the port's draw sites (every site resolved to a registered lane with
the right owner, a planted wrong-lane snippet flagged); the run
kernel's purpose constants; the models' draw purposes;
``check_ranges`` on each family's state after a short plain run, and a
planted out-of-range value."""

import _torch_threads  # noqa: F401
import dataclasses
import types

import numpy as np
import pytest
import torch

from madsim_tpu.lint.absint import LaneSite as JLaneSite
from madsim_tpu.lint.absint import check_lane_sites as j_check_lane_sites
from madsim_tpu_torch.engine import core as tcore
from madsim_tpu_torch.engine import rng as trng
from madsim_tpu_torch.lint import absint as ta
from madsim_tpu_torch.models import BENCH_SPECS, SOAK_SPECS

M32 = (1 << 32) - 1
U = trng.PURPOSE_USER
PLAN = trng.PURPOSE_PLAN


def _site(cls, path, purposes=None, lo=0, hi=0, x0=(0, M32), line=1):
    arr = None if purposes is None else np.asarray(purposes, np.uint32)
    if arr is not None:
        lo, hi = int(arr.min()), int(arr.max())
    return cls(path, ("madsim_tpu/x.py", line), arr, lo, hi, x0[0], x0[1], ("counter:step",))


# (path, purposes or None, p_lo, p_hi, x0 range) per site, per case
CASES = {
    "disjoint": [("eqns[1]", [0, 8, 9], 0, 0, (0, M32)), ("eqns[2]", [U], 0, 0, (0, M32))],
    "collision": [("eqns[1]", [U + 3], 0, 0, (0, M32)), ("eqns[7]", [U + 3], 0, 0, (5, 9))],
    "same-block-twice": [("eqns[1]", [8, 8, 9], 0, 0, (0, M32))],
    "unassigned": [("eqns[1]", [5], 0, 0, (0, M32))],
    "interval-two-lanes": [("eqns[1]", None, 60, 70, (0, M32))],
    "interval-one-lane": [("eqns[1]", None, PLAN, PLAN + 9, (0, M32)),
                          ("eqns[2]", [PLAN + 20], 0, 0, (0, M32))],
    "interval-meets-exact": [("eqns[1]", None, PLAN, PLAN + 9, (0, M32)),
                             ("eqns[2]", [PLAN + 4], 0, 0, (0, M32))],
    "branches": [("eqns[3].branch0.eqns[1]", [U + 1], 0, 0, (0, M32)),
                 ("eqns[3].branch1.eqns[4]", [U + 1], 0, 0, (0, M32))],
    "counters-apart": [("eqns[1]", [U], 0, 0, (0, 9)), ("eqns[2]", [U], 0, 0, (10, 20))],
    "intervals-overlap": [("eqns[1]", None, U, U + 50, (0, M32)),
                          ("eqns[2]", None, U + 40, U + 90, (0, M32))],
}


@pytest.mark.parametrize("case", list(CASES))
def test_check_lane_sites_agrees_with_the_jax_package(case):
    def sites(cls):
        return [_site(cls, p, ps, lo, hi, x0, line=i + 1)
                for i, (p, ps, lo, hi, x0) in enumerate(CASES[case])]

    # the port checks each site alone (its module docstring says why)
    want = [f for s in sites(JLaneSite) for f in j_check_lane_sites([s])]
    got = [f for s in sites(ta.LaneSite) for f in ta.check_lane_site(s)]
    assert got == want
    assert bool(got) == (case in ("same-block-twice", "unassigned", "interval-two-lanes"))


def test_every_draw_site_of_the_port_resolves_to_its_lane():
    sites, unresolved = ta.scan_draw_sites()
    assert unresolved == []
    assert ta.check_sites(sites) == []
    lanes = {ta.lane_of(r.site.p_lo).name for r in sites}
    assert lanes == {"poll_cost", "latency", "dup", "torn", "retry", "user", "plan",
                     "client", "explore", "farm"}
    by_file = {}
    for r in sites:
        by_file.setdefault(r.site.src[0].split("/")[1], set()).add(
            ta.lane_of(r.site.p_lo).owner)
    assert by_file == {"engine": {"engine", "user"}, "models": {"user"},
                       "chaos": {"chaos"}, "explore": {"explore", "farm"},
                       "farm": {"farm"}}
    # raft's one site: the election timeout, user purpose 0
    raft = [r.site for r in sites if r.site.src[0].endswith("models/raft.py")]
    assert [s.purpose_set() for s in raft] == [{U}]
    # the host stream's farm purpose comes from farm/, its explore one
    # from explore/: the owner is checked where the lane is named
    host = {r.origin[0].split("/")[1] for r in sites
            if r.site.src[0].endswith("explore/mutate.py")}
    assert host == {"explore", "farm"}


BAD = '''
from ..engine.rng import PURPOSE_PLAN, PURPOSE_USER, threefry2x32

_P_OK = 2


def make_bad():
    def on_tick(ctx):
        ok = ctx.draw.user_int(0, 10, _P_OK)
        plan = ctx.draw.bits(PURPOSE_PLAN + 3)
        nowhere = ctx.draw.bits(5)
        unknown = ctx.draw.bits(ctx.args[0])
        raw = threefry2x32(ctx.k0, ctx.k1, 0, PURPOSE_USER + 1)
        return ok, plan, nowhere, unknown, raw
    return on_tick
'''


def test_a_planted_wrong_lane_snippet_is_flagged():
    sites, unresolved = ta.scan_source(BAD, "madsim_tpu_torch/models/bad.py")
    assert [f["line"] for f in unresolved] == [12]
    findings = ta.check_sites(sites)
    msgs = sorted((f["line"], f["message"]) for f in findings)
    # PURPOSE_PLAN named in models/, and purpose 5 in unassigned space
    assert any("owner chaos" in f["message"] and "models/" in f["message"]
               for f in findings), msgs
    assert any("unassigned space" in f["message"] for f in findings), msgs
    assert len(findings) == 2
    # the same purposes in chaos/ break nothing but the user one
    sites, _ = ta.scan_source(BAD, "madsim_tpu_torch/chaos/bad.py")
    owners = sorted(f["message"].split("'")[1] for f in ta.check_sites(sites)
                    if "owner" in f["message"])
    assert owners == ["user", "user"]


def test_the_kernel_constants_are_the_registry(tmp_path):
    assert ta.check_kernel_constants() == []
    text = (ta._PKG / "csrc" / "engine_step.cuh").read_text()
    assert "constexpr uint32_t PURPOSE_USER = 128;" in text
    bad = tmp_path / "engine_step.cuh"
    bad.write_text(text.replace("PURPOSE_DUP = 64;", "PURPOSE_DUP = 65;"))
    got = ta.check_kernel_constants(bad)
    assert [f["message"] for f in got] == ["kernel PURPOSE_DUP = 65, the registry's is 64"]


def test_the_models_draw_purposes_are_distinct_user_purposes():
    assert ta.check_model_purposes() == []
    fake = types.SimpleNamespace(name="dup", draw_purposes=(0, 1, 1))
    wide = types.SimpleNamespace(name="wide", draw_purposes=(0, trng.lane("user").width))
    got = ta.check_model_purposes([fake, wide])
    assert [f["paths"] for f in got] == [["dup"], ["wide"]]


FAMILIES = {**BENCH_SPECS, **SOAK_SPECS}
TAPS = dict(metrics=True, cov_words=4, cov_hitcount=True, timeline_cap=8, causal=True)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_each_familys_state_holds_its_contracts(name):
    factory, kw, _n, _cap = FAMILIES[name]
    wl, cfg = factory(), tcore.EngineConfig(**kw)
    contracts = tcore.column_contracts(wl, cfg)
    st = tcore.make_init(wl, cfg, device="cpu", **TAPS)(np.arange(6, dtype=np.uint64))
    assert ta.check_ranges(st, contracts).ok
    out = tcore.make_run_plain(wl, cfg, 60, **TAPS)(st)
    rc = ta.check_ranges(out, contracts)
    assert rc.ok, rc.findings
    assert rc.uncertified == 0 and rc.n_seeds == 6


def test_check_ranges_flags_a_planted_value_and_skips_uncertified_seeds():
    factory, kw, _n, _cap = BENCH_SPECS["raft"]
    wl, cfg = factory(record=True), tcore.EngineConfig(**kw)
    contracts = tcore.column_contracts(wl, cfg, horizon_ns=60 * 10**9)
    st = tcore.make_run_plain(wl, cfg, 40, metrics=True)(
        tcore.make_init(wl, cfg, device="cpu", metrics=True)(np.arange(4, dtype=np.uint64)))
    epoch = st.ev_epoch.clone()
    epoch[2, 3] = -7
    count = st.hist_count.clone()
    count[1] = wl.history.capacity + 1
    rc = ta.check_ranges(dataclasses.replace(st, ev_epoch=epoch, hist_count=count), contracts)
    got = {f["field"]: (f["seeds"], f["first_seed"]) for f in rc.findings}
    assert got == {"ev_epoch": (1, 2), "hist_count": (1, 1)}
    # a seed past the horizon is uncertified, not a finding
    now = st.now.clone()
    now[2] = 61 * 10**9
    rc = ta.check_ranges(dataclasses.replace(st, ev_epoch=epoch, now=now), contracts)
    assert rc.findings == [] and rc.uncertified == 1
    # a uint64 word stored by its bit pattern is never out of range
    seed = torch.full_like(st.seed, -5)
    assert ta.check_ranges(dataclasses.replace(st, seed=seed), contracts).ok
