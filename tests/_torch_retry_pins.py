"""The client-retry soak's plans, in either package's classes, and the
JAX package's counts that ``chip_smoke.py`` phases 51-54 pin.

The plans, policies and configs are ``tools/retry_soak.py``'s (its
kvchaos army with and without the gray-failure slow link, its shardkv
army plan, clean and under the noidem hunt's name), and phase 54's is
``tools/step_goldens.py``'s ``kvchaos/army-obs`` plan with the soak's
kvchaos policy on its army.

Run as a script, it makes the JAX package's runs on the CPU of every
search and capture those phases hold the card to, and prints each
count::

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/_torch_retry_pins.py 2048

It writes nothing.
"""

import hashlib
import sys
import time

import numpy as np

N_OPS = 16
KV_CFG_KW = dict(pool_size=96, time_limit_ns=450_000_000, clog_backoff_max_ns=2_000_000_000)
SK_CFG_KW = dict(pool_size=96, time_limit_ns=600_000_000)
STEPS = 3000
KV_LAT_KW = dict(ops=N_OPS, phases=3, phase_ns=1 << 27)
SK_LAT_KW = dict(ops=N_OPS)
# phase 54: the step goldens' kvchaos army scenario with the policy
OBS_CFG_KW = dict(pool_size=72, loss_p=0.02, clog_backoff_max_ns=2_000_000_000)
OBS_LAT_KW = dict(ops=10, phases=3, phase_ns=1 << 27)
OBS_STEPS = 2000
OBS_TAPS = dict(metrics=True, causal=True, timeline_cap=256, cov_words=64, cov_hitcount=True)
OBS_DECODED = 8  # seeds 0..7 decoded for the Perfetto count


def policies(ch) -> tuple:
    """The soak's kvchaos and shardkv policies in ``ch``'s classes."""
    return (
        ch.RetryPolicy(timeout_ns=50_000_000, max_attempts=3, backoff_base_ns=10_000_000,
                       backoff_mult=2.0, jitter=0.5),
        ch.RetryPolicy(timeout_ns=8_000_000, max_attempts=3, backoff_base_ns=4_000_000,
                       backoff_mult=2.0, jitter=0.25),
    )


def retry_plans(ch, models) -> dict:
    """The soak's plans and phase 54's, with a ``chaos`` package ``ch``
    and a ``models`` package."""
    kv_pol, sk_pol = policies(ch)
    kv_army = models.kvchaos.client_army(n_ops=N_OPS, t_min_ns=5_000_000,
                                         t_max_ns=280_000_000, n_replicas=2, retry=kv_pol)
    gray = ch.GrayFailure(targets=(0, 3), n_links=1, mult_min=6, mult_max=12)

    def sk(name):
        return ch.FaultPlan(
            (models.shardkv.client_army(n_ops=N_OPS, t_min_ns=5_000_000,
                                        t_max_ns=280_000_000, retry=sk_pol),
             ch.GrayFailure(targets=(0, 1), n_links=1, mult_min=8, mult_max=16)),
            name=name,
        )

    servers = tuple(range(5))
    return {
        "kv-quiet": ch.FaultPlan((kv_army,), name="kv-retry-quiet"),
        "kv-gray": ch.FaultPlan((kv_army, gray), name="kv-retry-gray"),
        "sk-clean": sk("sk-retry-clean"),
        "sk-hunt": sk("sk-noidem-hunt"),
        "kv-obs": ch.FaultPlan((
            models.kvchaos.client_army(n_ops=10, t_min_ns=5_000_000, t_max_ns=400_000_000,
                                       retry=kv_pol),
            ch.CrashStorm(targets=servers, n=1, t_min_ns=50_000_000, t_max_ns=200_000_000,
                          down_min_ns=20_000_000, down_max_ns=80_000_000),
            ch.GrayFailure(targets=servers, n_links=1, mult_min=4, mult_max=8,
                           t_min_ns=30_000_000, t_max_ns=150_000_000, dur_min_ns=50_000_000,
                           dur_max_ns=150_000_000),
        )),
    }


def kv_inv(check):
    def inv(h):
        return check.stale_reads(h) & check.read_your_writes(h)

    return inv


def sk_inv(check, sk):
    def inv(h):
        return (check.exactly_once(h, sk.OP_ARMY_PUT)
                & check.shard_coverage(h, sk.OP_SHARD_OWN, sk.OP_SHARD_WRITE))

    return inv


def traces_digest(traces) -> str:
    """sha256 of the uint64 trace column, 16 hex digits."""
    return hashlib.sha256(np.asarray(traces, np.uint64).tobytes()).hexdigest()[:16]


def try_arrows(doc) -> int:
    """Flow arrows of a Perfetto document named by a retried attempt."""
    return sum(1 for r in doc["traceEvents"]
               if r.get("cat") == "flow" and r.get("ph") == "s" and " try" in r["name"])


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import madsim_tpu.chaos as jc
    import madsim_tpu.check as jk
    import madsim_tpu.models as jm
    from madsim_tpu import obs as jobs
    from madsim_tpu.engine import (
        MET_RETRY, MET_RETRY_GIVEUP, EngineConfig, LatencySpec, make_init, make_run_while,
        retry_token_attempt, search_seeds,
    )

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    plans = retry_plans(jc, jm)
    kv_cfg, sk_cfg = EngineConfig(**KV_CFG_KW), EngineConfig(**SK_CFG_KW)
    kv_lat, sk_lat = LatencySpec(**KV_LAT_KW), LatencySpec(**SK_LAT_KW)
    wl_kv = jm.make_kvchaos(writes=12, n_replicas=2, chaos=False, army=True, record=True)
    wl_sk = jm.make_shardkv(record=True, chaos=False, army=True)
    wl_bug = jm.make_shardkv(record=True, chaos=False, army=True, bug="noidem")
    print(f"# JAX package, platform {jax.devices()[0].platform}, {n} seeds; plans "
          + ", ".join(f"{k} {p.hash()}" for k, p in plans.items()), flush=True)

    def line(name, rep, t0, **more):
        met = np.asarray(rep.met).astype(np.int64) if rep.met is not None else None
        body = dict(failing=rep.failing_seeds.size, overflowed=int(rep.overflowed.sum()),
                    unhalted=rep.unhalted_seeds.size, traces=traces_digest(rep.traces))
        if met is not None:
            body.update(resends=int(met[:, MET_RETRY].sum()),
                        giveups=int(met[:, MET_RETRY_GIVEUP].sum()))
        body.update(more)
        print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in body.items())
              + f" ({time.monotonic() - t0:.1f} s)", flush=True)

    # phase 51, certificate 1: the clean models under retries
    t0 = time.monotonic()
    rep = search_seeds(wl_kv, kv_cfg, None, n_seeds=n, max_steps=STEPS, plan=plans["kv-gray"],
                       latency=kv_lat, metrics=True, require_halt=False,
                       history_invariant=kv_inv(jk))
    line("51 kvchaos clean under retries", rep, t0)
    t0 = time.monotonic()
    rep = search_seeds(wl_sk, sk_cfg, None, n_seeds=n, max_steps=STEPS,
                       plan=plans["sk-clean"], latency=sk_lat, metrics=True,
                       require_halt=False, history_invariant=sk_inv(jk, jm.shardkv))
    line("51 shardkv clean under retries", rep, t0)
    # phase 52, certificate 2: amplification over n // 4 seeds
    amp = max(64, n // 4)
    ones = lambda v: np.ones(np.asarray(v["halted"]).shape[0], bool)  # noqa: E731
    for key in ("kv-quiet", "kv-gray"):
        t0 = time.monotonic()
        rep = search_seeds(wl_kv, kv_cfg, ones, n_seeds=amp, max_steps=STEPS, plan=plans[key],
                           latency=kv_lat, metrics=True, require_halt=False)
        line(f"52 amplification {key}, {amp} seeds", rep, t0)
    # phase 53, certificate 3 on the fixed hunt plan: n // 2 seeds
    t0 = time.monotonic()
    hunt_n = n // 2
    rt = plans["sk-hunt"].retry_spec()

    def hinv(h):
        return jk.exactly_once(h, jm.shardkv.OP_ARMY_PUT)

    rep = search_seeds(wl_bug, sk_cfg, None, n_seeds=hunt_n, max_steps=STEPS,
                       plan=plans["sk-hunt"], latency=sk_lat, require_halt=False,
                       history_invariant=hinv)
    line(f"53 noidem sweep, {hunt_n} seeds", rep, t0,
         first=[int(s) for s in rep.failing_seeds[:8]])
    t0 = time.monotonic()
    eo = cov = 0
    box = {}

    def both(h):
        box["cov"] = jk.shard_coverage(h, jm.shardkv.OP_SHARD_OWN, jm.shardkv.OP_SHARD_WRITE)
        return hinv(h)

    first = rep.failing_seeds[:8]
    for s in first:
        one = search_seeds(wl_bug, sk_cfg, None, seeds=np.asarray([s], np.uint64),
                           max_steps=STEPS, plan=plans["sk-hunt"], history_invariant=both,
                           latency=sk_lat, require_halt=False, retry=rt)
        eo += int(not bool(np.asarray(one.ok)[0]))
        cov += int(not bool(box["cov"][0]))
    print(f"53 exclusivity over {len(first)} flagged: exactly_once {eo}, shard_coverage "
          f"{cov} ({time.monotonic() - t0:.1f} s)", flush=True)
    t0 = time.monotonic()
    seed = int(rep.failing_seeds[0])
    res = jc.shrink_plan(wl_bug, sk_cfg, seed, plans["sk-hunt"], history_invariant=hinv,
                         max_steps=STEPS, latency=sk_lat, retry=rt)
    print(f"53 shrink seed {seed}: events {[tuple(vars(e).values()) for e in res.events]}, "
          f"of {len(plans['sk-hunt'].compile(seed))}, rounds {res.rounds}, tested "
          f"{res.tested}, trace {res.trace:#x} ({time.monotonic() - t0:.1f} s)", flush=True)
    traces = []
    for _ in range(2):
        one = search_seeds(wl_bug, sk_cfg, None, seeds=np.asarray([seed], np.uint64),
                           max_steps=STEPS, plan=res.plan, history_invariant=hinv,
                           latency=sk_lat, require_halt=False, retry=rt)
        traces.append((bool(np.asarray(one.ok)[0]), int(np.asarray(one.traces)[0])))
    print(f"53 replays: {traces}", flush=True)
    # phase 54: the golden army scenario with the policy and every tap
    t0 = time.monotonic()
    wl = jm.make_kvchaos(record=True, army=True, army_probes=2)
    plan = plans["kv-obs"]
    seeds = np.arange(OBS_DECODED, dtype=np.uint64)
    lat = LatencySpec(**OBS_LAT_KW)
    rt = plan.retry_spec()
    cfg = EngineConfig(**OBS_CFG_KW)
    st = make_init(wl, cfg, plan_slots=plan.slots, latency=lat, retry=rt, time32=False,
                   **OBS_TAPS)(seeds, plan.compile_batch(seeds, wl=wl))
    out = jax.jit(make_run_while(wl, cfg, OBS_STEPS, latency=lat, retry=rt, layout="scatter",
                                 time32=False, **OBS_TAPS))(st)
    arrows = retried = 0
    for s in range(OBS_DECODED):
        ev = jobs.decode_timeline(out, wl, s)
        arrows += try_arrows(jobs.to_perfetto(ev, name=wl.name, seed=s))
        retried += sum(1 for e in ev if e.kind == rt.kind and e.node == rt.node
                       and retry_token_attempt(int(e.args[0])) > 0)
    met = np.asarray(out.met).astype(np.int64)
    print(f"54 {plan.hash()}: seeds 0-{OBS_DECODED - 1}, try arrows {arrows}, retried army "
          f"rows {retried}, resends {int(met[:, MET_RETRY].sum())}, giveups "
          f"{int(met[:, MET_RETRY_GIVEUP].sum())}, traces {traces_digest(out.trace)}, "
          f"dropped {int(np.asarray(out.tl_drop).sum())} ({time.monotonic() - t0:.1f} s)",
          flush=True)


if __name__ == "__main__":
    main()
