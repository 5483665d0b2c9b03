"""The explore soak's campaigns and the causal and retry hunts, in either
package's classes, and the JAX package's numbers that ``chip_smoke.py``
phases 55-58 pin (``EXPLORE_PINS``).

The plans, configs and campaign arguments are ``tools/explore_soak.py``'s
(certificates 1-4: the kvchaos lost-write mutant, guided against
uniform at 2,048 simulations a side, the 3 x 64 determinism campaign and
its shrink, the diskless-raftlog hunt and its shrink),
``tools/retry_soak.py``'s noidem hunt (3 x 128, root 14) and
``tools/causal_soak.py``'s cone hunt (2 x 256, root 2024).

Run as a script, it makes the JAX package's runs on the CPU and prints
``EXPLORE_PINS`` as a Python literal::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_explore_pins.py

It writes nothing (a few minutes on the CPU).
"""

import hashlib
import sys
import time

import numpy as np

KV_W, KV_STEPS, CW = 10, 4000, 64
KV_CFG_KW = dict(pool_size=192, loss_p=0.05)
RL_CFG_KW = dict(pool_size=128, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
RL_STEPS = 6000
GENS, BATCH = 8, 256
KV_RUN = dict(generations=GENS, batch=BATCH, root_seed=7, max_steps=KV_STEPS, cov_words=CW,
              max_ops=1, inherit_seed_p=0.9)
KV_SMALL = dict(KV_RUN, generations=3, batch=64)
HUNT_RUN = dict(generations=GENS, batch=BATCH, root_seed=2024, max_steps=RL_STEPS,
                cov_words=CW, select_top=24, max_ops=2, inherit_seed_p=0.85,
                require_halt=False)
# tools/retry_soak.py's noidem hunt (its plan: tests/_torch_retry_pins.py
# "sk-hunt") and tools/causal_soak.py's cone hunt
SK_CFG_KW = dict(pool_size=96, time_limit_ns=600_000_000)
SK_LAT_KW = dict(ops=16)
RETRY_RUN = dict(generations=3, batch=128, root_seed=14, max_steps=3000, cov_words=32,
                 select_top=16, max_ops=2)
CONE_CFG_KW = dict(pool_size=192, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
CONE_RUN = dict(generations=2, batch=256, root_seed=2024, max_steps=20000, cov_words=CW,
                select_top=24, max_ops=2, inherit_seed_p=0.85, require_halt=False)
RL_NODES = (0, 1, 2, 3, 4)


def kv_plan(ch):
    return ch.FaultPlan((
        ch.CrashStorm(targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
                      down_min_ns=50_000_000, down_max_ns=250_000_000),
    ), name="kv-nemesis")


def hunt_plan(ch, name="raftlog-hunt"):
    return ch.FaultPlan((
        ch.CrashStorm(targets=RL_NODES, n=2, t_min_ns=150_000_000, t_max_ns=500_000_000,
                      down_min_ns=100_000_000, down_max_ns=400_000_000),
        ch.FlappingPartition(targets=RL_NODES, n_cycles=2, t_min_ns=50_000_000,
                             t_max_ns=400_000_000, dur_min_ns=100_000_000,
                             dur_max_ns=300_000_000, up_min_ns=20_000_000,
                             up_max_ns=200_000_000),
    ), name=name)


def campaign_digest(rep) -> str:
    """sha256 of a campaign's corpus (ids, generations, parents, seeds,
    plan names and hashes, traces, new bits, verdicts, halt clocks),
    coverage map, violations and curves, 16 hex digits."""
    fp = (
        [(e.id, e.generation, e.parent, int(e.seed), e.plan.name, e.plan.hash(),
          int(e.trace), int(e.new_bits), bool(e.violating), int(e.halt_t))
         for e in rep.corpus],
        [int(w) for w in np.asarray(rep.cov_map, np.uint32)],
        [(int(e.seed), int(e.trace)) for e in rep.violations],
        [int(x) for x in rep.curve],
        [int(x) for x in rep.viol_curve],
    )
    return hashlib.sha256(repr(fp).encode()).hexdigest()[:16]


def first_key(rep):
    e = rep.violations[0]
    return (e.generation, e.id, int(e.seed), f"{int(e.trace):#x}")


def shrunk(res) -> dict:
    return dict(events=[tuple(int(x) for x in vars(e).values()) for e in res.events],
                original=res.original_events, rounds=res.rounds, tested=res.tested,
                trace=f"{res.trace:#x}")


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import madsim_tpu.chaos as jc
    import madsim_tpu.check as jk
    import madsim_tpu.explore as jx
    import madsim_tpu.models as jm
    from madsim_tpu.engine import EngineConfig, LatencySpec, search_seeds

    sys.path.insert(0, "tests")
    from _torch_retry_pins import retry_plans

    pins = {}

    def took(t0):
        return f"({time.monotonic() - t0:.1f} s)"

    def kv_inv(h):
        return jk.stale_reads(h) & jk.read_your_writes(h)

    # 55: guided against uniform at equal budget
    wl_kv = jm.make_kvchaos(writes=KV_W, record=True, bug=True, chaos=False)
    kv_cfg = EngineConfig(**KV_CFG_KW)
    t0 = time.monotonic()
    box = {}

    def kv_box(h):
        box["ok"] = kv_inv(h)
        return box["ok"]

    rep = search_seeds(wl_kv, kv_cfg, None, n_seeds=GENS * BATCH, max_steps=KV_STEPS,
                       history_invariant=kv_box, plan=kv_plan(jc), cov_words=CW)
    u_viol = int((~box["ok"] & ~rep.overflowed).sum())
    u_bits = jx.popcount(jx.merge(np.where(rep.overflowed[:, None], 0, rep.cov)))
    pins["uniform"] = (u_viol, u_bits)
    print(f"# 55 uniform: {u_viol} violations, {u_bits} bits {took(t0)}", flush=True)
    t0 = time.monotonic()
    g = jx.run(wl_kv, kv_cfg, kv_plan(jc), history_invariant=kv_inv, **KV_RUN)
    pins["guided"] = dict(viol=len(g.violations), bits=g.coverage_bits, curve=g.curve,
                          viol_curve=g.viol_curve, digest=campaign_digest(g))
    print(f"# 55 guided: {pins['guided']} {took(t0)}", flush=True)

    # 56: determinism, replay, shrink
    t0 = time.monotonic()
    d = jx.run(wl_kv, kv_cfg, kv_plan(jc), history_invariant=kv_inv, **KV_SMALL)
    e = d.violations[0]
    res = jc.shrink_plan(wl_kv, kv_cfg, e.seed, e.plan, history_invariant=kv_inv,
                         max_steps=KV_STEPS)
    pins["small"] = dict(viol=len(d.violations), digest=campaign_digest(d), first=first_key(d),
                         shrink=shrunk(res))
    print(f"# 56 small: {pins['small']} {took(t0)}", flush=True)

    # 57: the diskless-raftlog hunt and its shrink
    wl_rl = jm.make_raftlog(record=True, chaos=False, durable=False)
    rl_cfg = EngineConfig(**RL_CFG_KW)

    def rl_inv(h):
        return (jk.election_safety(h, elect_op=jm.raftlog.OP_COMMIT)
                & jk.election_safety(h, elect_op=jm.raftlog.OP_ELECT))

    t0 = time.monotonic()
    hunt = jx.run(wl_rl, rl_cfg, hunt_plan(jc), history_invariant=rl_inv, **HUNT_RUN)
    e = hunt.violations[0]
    res = jc.shrink_plan(wl_rl, rl_cfg, e.seed, e.plan, history_invariant=rl_inv,
                         max_steps=RL_STEPS)
    pins["hunt"] = dict(viol=len(hunt.violations), bits=hunt.coverage_bits, curve=hunt.curve,
                        viol_curve=hunt.viol_curve, digest=campaign_digest(hunt),
                        first=first_key(hunt), shrink=shrunk(res))
    print(f"# 57 hunt: {pins['hunt']} {took(t0)}", flush=True)

    # 58: the retry soak's noidem hunt and the causal soak's cone hunt
    t0 = time.monotonic()
    wl_bug = jm.make_shardkv(record=True, chaos=False, army=True, bug="noidem")
    r = jx.run(wl_bug, EngineConfig(**SK_CFG_KW), retry_plans(jc, jm)["sk-hunt"],
               history_invariant=lambda h: jk.exactly_once(h, jm.shardkv.OP_ARMY_PUT),
               latency=LatencySpec(**SK_LAT_KW), **RETRY_RUN)
    pins["retry"] = dict(viol=len(r.violations), sims=r.sims, digest=campaign_digest(r),
                         first=first_key(r))
    print(f"# 58 retry hunt: {pins['retry']} {took(t0)}", flush=True)
    t0 = time.monotonic()
    wl_w16 = jm.make_raftlog(record=True, chaos=False, durable=False, n_writes=16)
    c = jx.run(wl_w16, EngineConfig(**CONE_CFG_KW), hunt_plan(jc, "raftlog-cone-hunt"),
               history_invariant=rl_inv, **CONE_RUN)
    pins["cone"] = dict(viol=len(c.violations), sims=c.sims, digest=campaign_digest(c),
                        first=first_key(c))
    print(f"# 58 cone hunt: {pins['cone']} {took(t0)}", flush=True)
    print("EXPLORE_PINS = " + repr(pins), flush=True)


if __name__ == "__main__":
    main()
