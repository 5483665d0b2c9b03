"""The storage-fault soak's plans and invariants, in either package's
classes, and the JAX package's counts that ``chip_smoke.py`` phases 37.4
and 39 pin.

The plans are ``tools/store_soak.py``'s ``STORE_PLAN`` and
``LIE_PLAN``, the EIO storm of ``tests/test_lint.py``
(``test_raftlog_survives_eio_storm``) and ``tools/nemesis_soak.py``'s
``RAFT_PLAN`` (its certificate 4); the engine configs are theirs.

Run as a script, it makes the JAX package's runs on the CPU of every
search those phases hold the card to, and prints each count::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_store_pins.py 8192

It writes nothing.
"""

import hashlib
import sys
import time

import numpy as np

NODES = (0, 1, 2, 3, 4)
# raftlog durable=True at the store soak's shape, and at the nemesis
# soak's certificate 4
STORE_KW = dict(pool_size=128, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
NEMESIS_KW = dict(pool_size=96, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
STORE_STEPS = 6000
EIO_STEPS = 4000


def store_plans(m) -> dict:
    """The soaks' plans in module ``m``'s classes (a ``chaos`` package)."""
    crash = m.CrashStorm(targets=NODES, n=2, t_min_ns=150_000_000, t_max_ns=500_000_000,
                         down_min_ns=100_000_000, down_max_ns=400_000_000)
    return {
        "store": m.FaultPlan((
            crash,
            m.FlappingPartition(targets=NODES, n_cycles=2, t_min_ns=50_000_000,
                                t_max_ns=400_000_000, dur_min_ns=100_000_000,
                                dur_max_ns=300_000_000, up_min_ns=20_000_000,
                                up_max_ns=200_000_000),
            m.DiskFault(targets=NODES, n_torn=2, t_min_ns=50_000_000, t_max_ns=500_000_000),
        ), name="store-hunt"),
        "lie": m.FaultPlan((
            crash,
            m.DiskFault(targets=NODES, n_torn=0, n_sync_loss=3, t_min_ns=10_000_000,
                        t_max_ns=400_000_000, dur_min_ns=200_000_000,
                        dur_max_ns=600_000_000),
        ), name="lying-disk"),
        "eio": m.FaultPlan((
            crash,
            m.DiskFault(targets=NODES, n_torn=0, n_sync_loss=0, n_eio=3,
                        t_min_ns=10_000_000, t_max_ns=400_000_000,
                        dur_min_ns=100_000_000, dur_max_ns=400_000_000),
        ), name="eio-storm"),
        "raft": m.FaultPlan((
            m.CrashStorm(targets=NODES, n=2, t_min_ns=100_000_000, t_max_ns=600_000_000,
                         down_min_ns=100_000_000, down_max_ns=500_000_000),
            m.GrayFailure(targets=NODES, n_links=2, t_min_ns=50_000_000,
                          t_max_ns=500_000_000, dur_min_ns=100_000_000,
                          dur_max_ns=400_000_000, mult_min=4, mult_max=16),
        ), name="raft-nemesis"),
    }


def store_inv(check, rl, box: dict):
    """The store soak's history invariant (``check`` and raftlog module
    ``rl`` of one package), keeping each detector's verdicts in ``box``."""
    def inv(h):
        box["commit"] = check.election_safety(h, elect_op=rl.OP_COMMIT)
        box["elect"] = check.election_safety(h, elect_op=rl.OP_ELECT)
        box["recover"] = check.recovery_safety(h, sync_op=rl.OP_SYNCED,
                                               recover_op=rl.OP_RECOVER)
        return box["commit"] & box["elect"] & box["recover"]

    return inv


def raft_inv(check, rl, box: dict):
    """The nemesis soak's certificate 4 invariant."""
    def inv(h):
        box["ok"] = (check.election_safety(h, elect_op=rl.OP_ELECT)
                     & check.election_safety(h, elect_op=rl.OP_COMMIT))
        return box["ok"]

    return inv


def recovery_inv(check, rl):
    def inv(h):
        return check.recovery_safety(h, sync_op=rl.OP_SYNCED, recover_op=rl.OP_RECOVER)

    return inv


def traces_digest(traces) -> str:
    """sha256 of the uint64 trace column, 16 hex digits."""
    return hashlib.sha256(np.asarray(traces, np.uint64).tobytes()).hexdigest()[:16]


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import madsim_tpu.chaos as jc
    import madsim_tpu.check as jk
    import madsim_tpu.models.raftlog as jrl
    from madsim_tpu.engine import EngineConfig, search_seeds
    from madsim_tpu.engine.core import MET_CRASH, MET_SYNC, MET_SYNC_LOST, MET_TORN

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    plans = store_plans(jc)
    cfg, ncfg = EngineConfig(**STORE_KW), EngineConfig(**NEMESIS_KW)
    wl = jrl.make_raftlog(record=True, chaos=False, durable=True)
    wl_bug = jrl.make_raftlog(record=True, chaos=False, durable=True, bug="nosync")
    kw = dict(n_seeds=n, require_halt=False)
    print(f"# JAX package, platform {jax.devices()[0].platform}, {n} seeds; plans "
          + ", ".join(f"{k} {p.hash()}" for k, p in plans.items()), flush=True)

    def line(name, rep, t0, **more):
        body = ", ".join(f"{k} {v}" for k, v in more.items())
        print(f"{name}: failing {rep.failing_seeds.size}, overflowed "
              f"{int(rep.overflowed.sum())}, unhalted {rep.unhalted_seeds.size}, traces "
              f"{traces_digest(rep.traces)}{', ' if body else ''}{body} "
              f"({time.monotonic() - t0:.1f} s)", flush=True)

    t0 = time.monotonic()
    box = {}
    rep = search_seeds(wl, ncfg, None, n_seeds=n, max_steps=STORE_STEPS,
                       history_invariant=raft_inv(jk, jrl, box), plan=plans["raft"])
    line("37.4 nemesis certificate 4", rep, t0,
         violations=int((~box["ok"] & ~rep.overflowed).sum()))
    t0 = time.monotonic()
    rep = search_seeds(wl, cfg, None, max_steps=STORE_STEPS,
                       history_invariant=store_inv(jk, jrl, {}), **kw)
    line("39.1 certificate 1", rep, t0)
    t0 = time.monotonic()
    box = {}
    rep = search_seeds(wl, cfg, None, max_steps=STORE_STEPS, metrics=True,
                       history_invariant=store_inv(jk, jrl, box), plan=plans["store"], **kw)
    tot = rep.met.astype(np.int64).sum(0)
    line("39.2 certificate 2", rep, t0, sync=int(tot[MET_SYNC]),
         sync_lost=int(tot[MET_SYNC_LOST]), torn=int(tot[MET_TORN]),
         crash=int(tot[MET_CRASH]))
    t0 = time.monotonic()
    rep = search_seeds(wl, cfg, None, max_steps=STORE_STEPS,
                       history_invariant=recovery_inv(jk, jrl), plan=plans["lie"], **kw)
    line("39.3 certificate 3", rep, t0)
    t0 = time.monotonic()
    box = {}
    rep = search_seeds(wl_bug, cfg, None, max_steps=STORE_STEPS,
                       history_invariant=store_inv(jk, jrl, box), plan=plans["store"], **kw)
    loss = int((~box["commit"] & ~rep.overflowed).sum())
    line("39.4 the nosync mutant", rep, t0, commit_loss=loss,
         first=int(rep.failing_seeds[0]) if rep.failing_seeds.size else None)
    if rep.failing_seeds.size:
        t0 = time.monotonic()
        res = jc.shrink_plan(wl_bug, cfg, int(rep.failing_seeds[0]), plans["store"],
                             history_invariant=store_inv(jk, jrl, {}),
                             max_steps=STORE_STEPS)
        print(f"39.4 shrink: events {[tuple(vars(e).values()) for e in res.events]}, "
              f"rounds {res.rounds}, tested {res.tested}, plan_hash {res.plan.hash()}, "
              f"trace {res.trace:#x} ({time.monotonic() - t0:.1f} s)",
              flush=True)
    t0 = time.monotonic()
    rep = search_seeds(wl, cfg, None, max_steps=EIO_STEPS, metrics=True,
                       history_invariant=store_inv(jk, jrl, {}), plan=plans["eio"], **kw)
    line("39.5 the EIO storm", rep, t0,
         sync_lost_seeds=int((rep.met[:, MET_SYNC_LOST] > 0).sum()))


if __name__ == "__main__":
    main()
