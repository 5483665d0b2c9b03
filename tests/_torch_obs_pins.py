"""The flight soak's campaigns and the observability soak's raftlog
forensics, in either package's classes, and the JAX package's numbers that
``chip_smoke.py`` phases 60 and 64 pin (``OBS_PINS``).

``tools/flight_soak.py`` at its defaults: raft at pool 64 under its plan,
three campaigns of 4 x 4,096 (64 steps, 32 coverage words, roots 7, 8
and 9), and the halt-invariant campaign (3 x 4,096, 96 steps, root 7) on
both drivers. ``tools/obs_soak.py`` certificates 3 and 5: the
diskless-raftlog hunt (``raftlog-record-nochaos``, pool 128, 2 x 256, root
2024), its first find shrunk, replayed with a 4,096-row ring, written as
a Perfetto document and told by ``obs.explain`` (and with ``causal=True``).

Run as a script, it makes the JAX package's runs on the CPU and prints
``OBS_PINS`` as a Python literal::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_obs_pins.py

It writes nothing (several minutes on the CPU).
"""

import hashlib
import json
import sys
import time

FLIGHT_RUN = dict(generations=4, batch=4096, max_steps=64, cov_words=32)
FLIGHT_ROOTS = (7, 8, 9)
HALT_RUN = dict(generations=3, batch=4096, root_seed=7, max_steps=96, cov_words=32)
RL_CFG_KW = dict(pool_size=128, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
RL_STEPS = 6000
OBS_HUNT_RUN = dict(generations=2, batch=256, root_seed=2024, max_steps=RL_STEPS, cov_words=64,
                    select_top=24, max_ops=2, inherit_seed_p=0.85, require_halt=False)
EXPLAIN_KW = dict(max_steps=RL_STEPS, timeline_cap=4096, max_events=40)

# what the JAX package's run of this script printed (OBS_PINS)
OBS_PINS = {'flight': {7: {'corpus': 41, 'bits': 154, 'digest': '7fafab498658fdfa'}, 8: {'corpus': 46, 'bits': 172, 'digest': 'b693ece38b05c9ec'}, 9: {'corpus': 57, 'bits': 165, 'digest': '2bfe7c35ffb55328'}}, 'halt': {'corpus': 180, 'viol': 139, 'digest': '361f13d697e7810f'}, 'hunt': {'viol': 9, 'bits': 938, 'digest': '85e7455227fd3f4b'}, 'forensics': {'events': 120, 'refold': True, 'trace': '0x2418867612c8a9c', 'perfetto': 'ae0b20fb38e2dd0b', 'explain': 'e9a751e45b2bb9b2', 'explain_causal': '72d716b64f872846', 'shrunk': 5}}


def flight_plan(ch):
    nodes = (0, 1, 2, 3, 4)
    return ch.FaultPlan((
        ch.CrashStorm(targets=(1, 2, 3), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
                      down_min_ns=50_000_000, down_max_ns=250_000_000),
        ch.PauseStorm(targets=nodes, n=1, t_min_ns=20_000_000, t_max_ns=300_000_000,
                      down_min_ns=50_000_000, down_max_ns=200_000_000),
        ch.GrayFailure(targets=nodes, n_links=1),
    ), name="flight-soak")


def rl_inv(kk, raftlog):
    return lambda h: (kk.election_safety(h, elect_op=raftlog.OP_COMMIT)
                      & kk.election_safety(h, elect_op=raftlog.OP_ELECT))


def sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def doc_digest(doc) -> str:
    return sha(json.dumps(doc, sort_keys=True))


def forensics(x, ob, ch, wl, cfg, inv, hunt) -> dict:
    """Certificate 3's forensics of a hunt's first find: the shrink, the
    ring replay, the Perfetto document and the two explain texts."""
    e = hunt.violations[0]
    res = ch.shrink_plan(wl, cfg, e.seed, e.plan, history_invariant=inv, max_steps=RL_STEPS)
    r = x.replay_entry(wl, cfg, x.CorpusEntry(
        id=-1, generation=-1, parent=-1, seed=e.seed, plan=res.plan, trace=res.trace,
        cov=e.cov, new_bits=0, violating=True), history_invariant=inv, max_steps=RL_STEPS,
        timeline_cap=4096, metrics=True, **({"device": "cpu"} if _is_port(x) else {}))
    events = ob.decode_timeline(r.timeline, wl, 0)
    doc = ob.to_perfetto(events, wl, seed=e.seed)
    text = ob.explain(wl, cfg, seed=e.seed, plan=res.plan, history_invariant=inv,
                      **EXPLAIN_KW, **({"device": "cpu"} if _is_port(x) else {}))
    ctext = ob.explain(wl, cfg, seed=e.seed, plan=res.plan, history_invariant=inv, causal=True,
                       **EXPLAIN_KW, **({"device": "cpu"} if _is_port(x) else {}))
    return dict(events=len(events), refold=ob.refold_timeline(events, wl) == int(r.traces[0]),
                trace=f"{int(r.traces[0]):#x}", perfetto=doc_digest(doc), explain=sha(text),
                explain_causal=sha(ctext), shrunk=len(res.events))


def _is_port(mod) -> bool:
    return mod.__name__.startswith("madsim_tpu_torch")


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import madsim_tpu.chaos as jc
    import madsim_tpu.check as jk
    import madsim_tpu.explore as jx
    import madsim_tpu.models as jm
    import madsim_tpu.obs as jo
    from madsim_tpu.engine import EngineConfig

    sys.path.insert(0, "tests")
    from _torch_explore_pins import campaign_digest
    from _torch_farm_pins import invariants

    pins = {}

    def took(t0):
        return f"({time.monotonic() - t0:.1f} s)"

    inv = invariants()
    wl, cfg, plan = jm.make_raft(), EngineConfig(pool_size=64, loss_p=0.02), flight_plan(jc)
    t0 = time.monotonic()
    pins["flight"] = {}
    for root in FLIGHT_ROOTS:
        r = jx.run_device(wl, cfg, plan, invariant=inv["cov"], root_seed=root, **FLIGHT_RUN)
        pins["flight"][root] = dict(corpus=len(r.corpus), bits=r.coverage_bits,
                                    digest=campaign_digest(r))
    print(f"# 60 campaigns: {pins['flight']} {took(t0)}", flush=True)
    t0 = time.monotonic()
    d = jx.run_device(wl, cfg, plan, invariant=inv["halt"], **HALT_RUN)
    h = jx.run(wl, cfg, plan, invariant=inv["halt"], **HALT_RUN)
    assert campaign_digest(d) == campaign_digest(h)
    pins["halt"] = dict(corpus=len(d.corpus), viol=len(d.violations), digest=campaign_digest(d))
    print(f"# 60 halt hunt: {pins['halt']} {took(t0)}", flush=True)
    t0 = time.monotonic()
    wl_rl = jm.make_raftlog(record=True, chaos=False, durable=False)
    rl_cfg = EngineConfig(**RL_CFG_KW)
    rinv = rl_inv(jk, jm.raftlog)
    hunt = jx.run(wl_rl, rl_cfg, _hunt_plan(jc), history_invariant=rinv, **OBS_HUNT_RUN)
    pins["hunt"] = dict(viol=len(hunt.violations), bits=hunt.coverage_bits,
                        digest=campaign_digest(hunt))
    pins["forensics"] = forensics(jx, jo, jc, wl_rl, rl_cfg, rinv, hunt)
    print(f"# 64 hunt: {pins['hunt']} {pins['forensics']} {took(t0)}", flush=True)
    print("OBS_PINS = " + repr(pins), flush=True)


def _hunt_plan(ch):
    sys.path.insert(0, "tests")
    from _torch_explore_pins import hunt_plan

    return hunt_plan(ch)


if __name__ == "__main__":
    main()
