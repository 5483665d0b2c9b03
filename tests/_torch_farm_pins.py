"""The farm soak's campaigns, in either package's classes, and the JAX
package's numbers that ``chip_smoke.py`` phases 61-63 pin (``FARM_PINS``).

The plans, configs and campaign arguments are ``tools/farm_soak.py``'s at
its defaults (batch 1,024, 6 generations): certificate 1's raft campaign
(pool 64, 256 steps, 32 coverage words), certificate 2's three tenants,
certificate 3's adaptive-against-uniform hunts on the kvchaos lost-write
mutant (pool 192, loss 0.02, 800 steps, 8 x 256, roots 7, 13 and 29) and
certificate 4's three-generation campaign, with energy absent.

Run as a script, it makes the JAX package's runs on the CPU and prints
``FARM_PINS`` as a Python literal::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_farm_pins.py

It writes nothing (several minutes on the CPU).
"""

import sys
import time

NODES = (0, 1, 2, 3, 4)
CFG_KW = dict(pool_size=64, loss_p=0.02)
FARM_RUN = dict(generations=6, batch=1024, root_seed=7, max_steps=256, cov_words=32)
# certificate 2: the tenants at the soak's tb = batch // 4 (invariant by name)
TENANTS = {
    "halt": dict(batch=256, root_seed=11, max_steps=256, cov_words=32),
    "biased": dict(batch=272, root_seed=5, max_steps=256, cov_words=32),
    "wide": dict(batch=256, root_seed=2, max_steps=384, cov_words=64),
}
TENANT_INV = {"halt": "halt", "biased": "biased", "wide": "halt"}
KV_CFG_KW = dict(pool_size=192, loss_p=0.02)
KV_RUN = dict(generations=8, batch=256, max_steps=800, cov_words=64, max_ops=1,
              inherit_seed_p=0.9)
KV_ROOTS = (7, 13, 29)
INERT_RUN = dict(KV_RUN, generations=3, root_seed=7)

# what the JAX package's run of this script printed (FARM_PINS)
FARM_PINS = {'blocking': {'corpus': 52, 'bits': 204, 'viol': 0, 'digest': '3f1061e9bb7cde8b'}, 'tenants': {'halt': {'corpus': 109, 'bits': 201, 'viol': 64, 'digest': '2c5a11e8689617a4'}, 'biased': {'corpus': 229, 'bits': 191, 'viol': 191, 'digest': 'bb272d60b7bed63b'}, 'wide': {'corpus': 50, 'bits': 218, 'viol': 4, 'digest': 'ed77cfbfe2d8c7e9'}}, 'energy': {7: (931, 325, 1039, 324), 13: (904, 325, 1000, 325), 29: (986, 328, 974, 323)}, 'inert': {'corpus': 273, 'viol': 249, 'digest': '1f845d46e16f30a4'}}


def farm_plan(ch, name="farm-soak"):
    return ch.FaultPlan((
        ch.CrashStorm(targets=(1, 2, 3), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
                      down_min_ns=50_000_000, down_max_ns=250_000_000),
        ch.PauseStorm(targets=NODES, n=1, t_min_ns=20_000_000, t_max_ns=300_000_000,
                      down_min_ns=50_000_000, down_max_ns=200_000_000),
        ch.GrayFailure(targets=NODES, n_links=1),
    ), name=name)


def kv_plan(ch):
    return ch.FaultPlan((
        ch.CrashStorm(targets=(1, 2, 3, 4), n=2, t_min_ns=20_000_000, t_max_ns=400_000_000,
                      down_min_ns=50_000_000, down_max_ns=250_000_000),
    ), name="kv-nemesis")


def invariants() -> dict:
    """The soak's final-state invariants; each works on a numpy or a
    torch view."""
    return {
        "cov": lambda view: view["halted"] | True,
        "halt": lambda view: view["halted"],
        "biased": lambda view: (view["trace"] & 7) != 0,
    }


def kv_hinv(kk):
    return lambda h: kk.stale_reads(h) & kk.read_your_writes(h)


def energy_counts(x, farm, wl, cfg, plan, hinv, roots=KV_ROOTS, run=KV_RUN) -> dict:
    """Per root: (uniform violations, bits, adaptive violations, bits)."""
    out = {}
    for rs in roots:
        u = x.run(wl, cfg, plan, root_seed=rs, history_invariant=hinv, **run)
        a = x.run(wl, cfg, plan, root_seed=rs, history_invariant=hinv,
                  energy=farm.EnergySchedule(), **run)
        out[rs] = (len(u.violations), u.coverage_bits, len(a.violations), a.coverage_bits)
    return out


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import madsim_tpu.chaos as jc
    import madsim_tpu.check as jk
    import madsim_tpu.explore as jx
    import madsim_tpu.farm as jf
    import madsim_tpu.models as jm
    from madsim_tpu.engine import EngineConfig

    sys.path.insert(0, "tests")
    from _torch_explore_pins import campaign_digest

    pins = {}

    def took(t0):
        return f"({time.monotonic() - t0:.1f} s)"

    inv = invariants()
    wl, cfg, plan = jm.make_raft(), EngineConfig(**CFG_KW), farm_plan(jc)
    t0 = time.monotonic()
    rep = jx.run_device(wl, cfg, plan, invariant=inv["cov"], **FARM_RUN)
    pins["blocking"] = dict(corpus=len(rep.corpus), bits=rep.coverage_bits,
                            viol=len(rep.violations), digest=campaign_digest(rep))
    print(f"# 61 blocking: {pins['blocking']} {took(t0)}", flush=True)
    t0 = time.monotonic()
    pins["tenants"] = {}
    for n, k in TENANTS.items():
        r = jx.run_device(wl, cfg, plan, invariant=inv[TENANT_INV[n]],
                          generations=FARM_RUN["generations"], **k)
        pins["tenants"][n] = dict(corpus=len(r.corpus), bits=r.coverage_bits,
                                  viol=len(r.violations), digest=campaign_digest(r))
    print(f"# 62 tenants: {pins['tenants']} {took(t0)}", flush=True)
    wl_bug = jm.make_kvchaos(writes=10, record=True, bug=True, chaos=False)
    kv_cfg = EngineConfig(**KV_CFG_KW)
    t0 = time.monotonic()
    pins["energy"] = energy_counts(jx, jf, wl_bug, kv_cfg, kv_plan(jc), kv_hinv(jk))
    print(f"# 63 energy: {pins['energy']} {took(t0)}", flush=True)
    t0 = time.monotonic()
    r = jx.run(wl_bug, kv_cfg, kv_plan(jc), history_invariant=kv_hinv(jk), **INERT_RUN)
    pins["inert"] = dict(corpus=len(r.corpus), viol=len(r.violations),
                         digest=campaign_digest(r))
    print(f"# 63 inert: {pins['inert']} {took(t0)}", flush=True)
    print("FARM_PINS = " + repr(pins), flush=True)


if __name__ == "__main__":
    main()
