"""The store soak's missing-sync hunt and the latency soak's guided SLO
hunt, in either package's classes, and the JAX package's numbers that
``chip_smoke.py`` phases 67 and 68 pin (``HUNT_PINS``).

``tools/store_soak.py`` certificate 4: raftlog ``durable=True``,
``record=True``, ``bug="nosync"`` at the store config (pool 128) under
``STORE_PLAN``, 8 x 256 from root 1031 with the soak's history invariant,
its first violation replayed, shrunk, the shrunk plan replayed with
``search_seeds`` and told by ``obs.explain(max_events=24)``.
``tools/latency_soak.py`` certificates 4-5: the SLO bound calibrated at
the worst window-p99 bucket of a uniform sweep of 2,048 over the blip
space, the guided campaign (8 x 256, root 7, the latency tap) judged by
``slo_bounded``, its first breach shrunk, replayed and told by
``obs.explain(timeline_cap=4096, latency=SPEC)``.

Run as a script, it makes the JAX package's runs on the CPU and prints
``HUNT_PINS`` as a Python literal::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_hunt_pins.py [store|slo]

It writes nothing (some minutes on the CPU).
"""

import dataclasses
import hashlib
import sys
import time
from types import SimpleNamespace

import numpy as np

NODES = (0, 1, 2, 3, 4)
STORE_KW = dict(pool_size=128, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
STORE_STEPS = 6000
STORE_RUN = dict(generations=8, batch=256, root_seed=1031, max_steps=STORE_STEPS,
                 cov_words=64, select_top=24, max_ops=2, inherit_seed_p=0.85,
                 require_halt=False)
STORE_EXPLAIN_EVENTS = 24
LAT_KW = dict(pool_size=160, time_limit_ns=700_000_000)
LAT_STEPS = 4000
LAT_OPS = 64
SLO_RUN = dict(generations=8, batch=256, root_seed=7, max_steps=LAT_STEPS, cov_words=64)
SLO_Q, SLO_MIN_OPS = 0.99, 8
SLO_RING = 4096

# what the JAX package's run of this script printed (HUNT_PINS)
HUNT_PINS = {'store': {'viol': 705,
           'bits': 1098,
           'curve': [885, 972, 1022, 1059, 1069, 1077, 1081, 1098],
           'viol_curve': [1, 4, 27, 152, 276, 409, 554, 705],
           'first': (0, 34, 10636629163940057250, '0x7032cca88c216057'),
           'replay': (True, True),
           'kind': 'committed-value-loss',
           'shrink': {'events': [(232728095, 0, 4, 0, 0),
                                 (418142506, 1, 4, 0, 0),
                                 (168363485, 2, 0, 1, 0),
                                 (427471745, 3, 0, 1, 0),
                                 (168363485, 2, 0, 2, 0),
                                 (427471745, 3, 0, 2, 0),
                                 (168363485, 2, 1, 3, 0),
                                 (427471745, 3, 1, 3, 0),
                                 (168363485, 2, 1, 4, 0),
                                 (427471745, 3, 1, 4, 0),
                                 (168363485, 2, 2, 3, 0),
                                 (427471745, 3, 2, 3, 0),
                                 (168363485, 2, 2, 4, 0),
                                 (427471745, 3, 2, 4, 0),
                                 (69712644, 253, 0, 0, 0),
                                 (381066598, 254, 0, 0, 0),
                                 (132316564, 253, 1, 0, 0),
                                 (425163044, 254, 1, 0, 0)],
                      'original': 32,
                      'rounds': 8,
                      'tested': 116,
                      'trace': '0xec11f9e5d9f51598'},
           'shrunk_replay': (True, True),
           'explain': 'c7d986da41d300a1c9404860979d01ecc1d33e7934dba737eb72696b59ead2a3'},
 'slo': {'uniform': (2048, 47, 225726413, 0),
         'viol': 1262,
         'bits': 176,
         'curve': [156, 174, 174, 174, 174, 176, 176, 176],
         'viol_curve': [0, 3, 48, 287, 529, 773, 1017, 1262],
         'first': (1, 19, 2505859882325233988, '0xefb58ae5f2ca3821'),
         'shrink': {'events': [(216806840, 22, 45, 0, 3),
                               (92620344, 22, 46, 0, 3),
                               (145287155, 22, 47, 0, 3),
                               (123946823, 22, 51, 0, 3),
                               (8856170, 22, 52, 0, 3),
                               (236661001, 22, 54, 0, 3),
                               (112008222, 22, 62, 0, 3),
                               (236468391, 22, 63, 0, 3),
                               (198496023, 244, 3, 3073, 0)],
                    'original': 66,
                    'rounds': 18,
                    'tested': 308,
                    'trace': '0x77f739d62e526967'},
         'replay': (True, True),
         'narrates': (True, True),
         'explain': 'a07a4412417d402e004a8b6b790f13d6640421ef2f2691e7f1a2793d62f9f75e'}}


def package(port: bool) -> SimpleNamespace:
    """The modules the hunts use, of the port or of the JAX package."""
    if port:
        from madsim_tpu_torch import chaos, check, engine, explore, obs
        from madsim_tpu_torch.models import kvchaos, raftlog
    else:
        from madsim_tpu import chaos, check, engine, explore, obs
        from madsim_tpu.models import kvchaos, raftlog
    return SimpleNamespace(chaos=chaos, check=check, engine=engine, explore=explore, obs=obs,
                           kvchaos=kvchaos, raftlog=raftlog, port=port)


def store_plan(ch):
    """``tools/store_soak.py``'s ``STORE_PLAN`` in chaos package ``ch``."""
    return ch.FaultPlan((
        ch.CrashStorm(targets=NODES, n=2, t_min_ns=150_000_000, t_max_ns=500_000_000,
                      down_min_ns=100_000_000, down_max_ns=400_000_000),
        ch.FlappingPartition(targets=NODES, n_cycles=2, t_min_ns=50_000_000,
                             t_max_ns=400_000_000, dur_min_ns=100_000_000,
                             dur_max_ns=300_000_000, up_min_ns=20_000_000,
                             up_max_ns=200_000_000),
        ch.DiskFault(targets=NODES, n_torn=2, t_min_ns=50_000_000, t_max_ns=500_000_000),
    ), name="store-hunt")


def store_inv(p, box: dict):
    """The store soak's history invariant, each detector's verdicts kept
    in ``box``."""
    rl, ck = p.raftlog, p.check

    def inv(h):
        box["commit"] = ck.election_safety(h, elect_op=rl.OP_COMMIT)
        box["elect"] = ck.election_safety(h, elect_op=rl.OP_ELECT)
        box["recover"] = ck.recovery_safety(h, sync_op=rl.OP_SYNCED, recover_op=rl.OP_RECOVER)
        return box["commit"] & box["elect"] & box["recover"]

    return inv


def slo_space(p):
    """``(workload, config, spec, space)`` of the latency soak's hunt:
    kvchaos (two replicas, no chaos of its own, a 64-op army of three
    rounds), pool 160, a 700 ms clock cap, two 268 ms windows, and the
    ``hunt_gray`` blip space."""
    kv, ch = p.kvchaos, p.chaos
    wl = kv.make_kvchaos(writes=20, n_replicas=2, chaos=False, army=True, army_probes=3)
    army = kv.client_army(n_ops=LAT_OPS, t_min_ns=5_000_000, t_max_ns=500_000_000,
                          n_replicas=2)
    blip = ch.GrayFailure(targets=(0, 1, 2, 3), n_links=1, mult_min=4, mult_max=12,
                          t_min_ns=20_000_000, t_max_ns=600_000_000,
                          dur_min_ns=50_000_000, dur_max_ns=80_000_000)
    return (wl, p.engine.EngineConfig(**LAT_KW),
            p.engine.LatencySpec(ops=LAT_OPS, phases=2, phase_ns=1 << 28),
            ch.FaultPlan((army, blip), name="slo-hunt"))


def sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def campaign_pins(rep) -> dict:
    """A campaign's violations, coverage bits, curves and first find
    (generation, id, seed, trace)."""
    e = rep.violations[0] if rep.violations else None
    return dict(viol=len(rep.violations), bits=rep.coverage_bits, curve=list(rep.curve),
                viol_curve=list(rep.viol_curve),
                first=(e.generation, e.id, int(e.seed), f"{int(e.trace):#x}") if e else None)


def shrink_pins(res) -> dict:
    return dict(events=[tuple(int(x) for x in vars(e).values()) for e in res.events],
                original=res.original_events, rounds=res.rounds, tested=res.tested,
                trace=f"{res.trace:#x}")


def store_hunt(p, run_kw: dict = STORE_RUN, dev: dict | None = None, hook=None) -> dict:
    """Store certificate 4 in package ``p``: the campaign, its first
    violation replayed, shrunk, the shrunk plan replayed by
    ``search_seeds``, and the ``explain`` text's sha256. ``dev`` is the
    port's ``device=`` keyword (empty for the JAX package); ``hook``,
    when given, is called with the campaign's report."""
    dev = dev or {}
    steps = run_kw["max_steps"]
    wl = p.raftlog.make_raftlog(record=True, chaos=False, durable=True, bug="nosync")
    cfg, plan = p.engine.EngineConfig(**STORE_KW), store_plan(p.chaos)
    hunt = p.explore.run(wl, cfg, plan, history_invariant=store_inv(p, {}), **run_kw, **dev)
    if hook is not None:
        hook(hunt)
    out = campaign_pins(hunt)
    if not hunt.violations:
        return out
    e = hunt.violations[0]
    box = {}
    r = p.explore.replay_entry(wl, cfg, e, history_invariant=store_inv(p, box),
                               max_steps=steps, **dev)
    out["replay"] = (int(r.traces[0]) == e.trace, not bool(r.ok[0]))
    out["kind"] = ("committed-value-loss" if not bool(box["commit"][0]) else
                   "double-vote" if not bool(box["elect"][0]) else "recovery-regression")
    res = p.chaos.shrink_plan(wl, cfg, e.seed, e.plan, history_invariant=store_inv(p, {}),
                              max_steps=steps, **dev)
    out["shrink"] = shrink_pins(res)
    rs = p.engine.search_seeds(wl, cfg, None, seeds=np.asarray([e.seed], np.uint64),
                               max_steps=steps, history_invariant=store_inv(p, {}),
                               plan=res.plan, require_halt=False, **dev)
    out["shrunk_replay"] = (int(rs.traces[0]) == res.trace, not bool(rs.ok[0]))
    text = p.obs.explain(wl, cfg, e.seed, plan=res.plan, history_invariant=store_inv(p, {}),
                         max_steps=steps, max_events=STORE_EXPLAIN_EVENTS, **dev)
    out["explain"] = sha(text)
    return out


def slo_hunt(p, run_kw: dict = SLO_RUN, dev: dict | None = None, hook=None,
             ring: int = SLO_RING) -> dict:
    """Latency certificates 4-5 in package ``p``: the uniform sweep at the
    campaign's budget calibrates the bound at its worst window-p99
    bucket; the guided campaign judged by ``slo_bounded`` at that bound;
    its first breach shrunk and replayed; ``explain`` with a ``ring``-row
    ring and the tap, its sha256 and whether it narrates the percentiles
    and the verdict. ``hook`` gets the uniform report and the campaign."""
    dev = dev or {}
    wl, cfg, spec, space = slo_space(p)
    steps = run_kw["max_steps"]
    budget = run_kw["generations"] * run_kw["batch"]
    ones = lambda v: np.ones(np.asarray(v["halted"]).shape[0], bool)  # noqa: E731
    uni = p.engine.search_seeds(wl, cfg, ones, plan=space, n_seeds=budget, max_steps=steps,
                                require_halt=False, latency=spec, **dev)
    hist = np.asarray(uni.lat_hist)
    qb = np.asarray(p.obs.hist_quantile_bucket(hist, SLO_Q))
    qb = np.where(hist.sum(axis=-1) >= SLO_MIN_OPS, qb, -1)
    worst = int(qb.max())
    bound = int(p.engine.lat_bucket_hi(worst))
    slo = p.check.slo_bounded(bound, q=SLO_Q, min_ops=SLO_MIN_OPS)
    uni_found = int(np.asarray(p.check.slo_breaches(hist, bound, q=SLO_Q,
                                                    min_ops=SLO_MIN_OPS)).sum())
    rep = p.explore.run(wl, cfg, space, invariant=slo, latency=spec, **run_kw, **dev)
    if hook is not None:
        hook(uni, rep)
    out = dict(uniform=(budget, worst, bound, uni_found), **campaign_pins(rep))
    if not rep.violations:
        return out
    e = rep.violations[0]
    res = p.chaos.shrink_plan(wl, cfg, e.seed, e.plan, invariant=slo, max_steps=steps,
                              latency=spec, **dev)
    out["shrink"] = shrink_pins(res)
    r = p.explore.replay_entry(wl, cfg, dataclasses.replace(e, plan=res.plan), invariant=slo,
                               max_steps=steps, latency=spec, **dev)
    out["replay"] = (int(r.traces[0]) == res.trace, not bool(r.ok[0]))
    text = p.obs.explain(wl, cfg, e.seed, plan=res.plan, invariant=slo, max_steps=steps,
                         timeline_cap=ring, latency=spec, **dev)
    out["narrates"] = ("--- latency:" in text and "p99<=" in text, "VIOLATED" in text)
    out["explain"] = sha(text)
    return out


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    p = package(port=False)
    which = sys.argv[1:] or ["store", "slo"]
    pins = {}
    for name in which:
        t0 = time.monotonic()
        pins[name] = (store_hunt if name == "store" else slo_hunt)(p)
        print(f"# {name}: {pins[name]} ({time.monotonic() - t0:.1f} s)", flush=True)
    print("HUNT_PINS = " + repr(pins), flush=True)


if __name__ == "__main__":
    main()
