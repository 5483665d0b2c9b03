"""The etcd lease convergence, for either package.

One scenario, two execution modes (``tests/test_leasekv.py``'s
``TestDualModeConvergence``): three clients each hold a 5 s TTL lease
and a key under it, and renew it every second; client 1 stops renewing
at 2 s. The batched side is leasekv-record without its own chaos, with
``ka_stop_ms``; the host side is the etcd simulator (``SimServer`` and
three ``Client.lease_client()`` users, each on its own node) on one
``Runtime`` a seed, with a watcher node that polls the server's leases
and keys. Both must say: lease 1 expires, leases 2 and 3 survive, and
only lease 1's key is deleted.

``chip_smoke.py`` imports this module for its lease phase, so it imports
nothing of the JAX package itself: the package is an argument.
"""

from __future__ import annotations

import importlib

TTL_S, KA_S, STALL_S, END_S = 5, 1.0, 2.0, 12.0
POLL_S = 0.1
SERVER_IP, PORT = "10.0.0.1", 2379
LEASES = (1, 2, 3)
# the batched side: the JAX test's configuration
POOL, STEPS = 48, 140
FACTORY_KW = dict(ttl_ms=TTL_S * 1000, ka_ms=1000, scan_ms=1000, put_ms=1_000_000,
                  ka_stop_ms=int(STALL_S * 1000), chaos=False, record=True)
# Where the expiry of lease 1 falls, in whole seconds of simulated time.
# The host side: the JAX package's etcd server on seeds 0..255 expires
# it at the tick of 6 s on every seed (granted at about 0.1 s, renewed
# once at about 1.1 s, then five ticks down; the watcher sees it at most
# one poll later). The batched side: the scan of 7 s (the renewal sets
# the deadline to 6 s plus the message's latency on the server's clock,
# and the scan runs each whole second). The card's second minus the
# host's is the JAX test's window, 0 to 2 s, and on these seeds it is 1.
HOST_EXPIRY_S = (6, 6)
CARD_MINUS_HOST_S = (0, 2)


def lease_cluster(ms, seed: int) -> dict:
    """Run the host side on ``ms.Runtime(seed=seed)``. Returns ``log``
    (every grant, renewal and watcher observation with its virtual time
    in ns), ``expired`` ``{lease: ns first seen gone}``, ``alive`` (the
    leases the server holds at the end) and ``keys`` (the keys left)."""
    etcd = importlib.import_module(f"{ms.__name__}.services.etcd")
    log = []

    async def main():
        h = ms.Handle.current()
        server = etcd.SimServer()
        h.create_node().name("etcd").ip(SERVER_IP).init(
            lambda: server.serve(f"0.0.0.0:{PORT}")).build()
        addr = f"{SERVER_IP}:{PORT}"

        async def client(lid):
            await ms.sleep(POLL_S)
            c = await etcd.Client.connect([addr])
            leases = c.lease_client()
            g = await leases.grant(TTL_S, lid)
            await c.put(f"/svc/{lid}", f"client-{lid}", etcd.PutOptions(lease=g["id"]))
            log.append(["grant", lid, g["ttl"], ms.now_ns()])
            while ms.now_ns() < END_S * 1e9:
                await ms.sleep(KA_S)
                if lid == 1 and ms.now_ns() >= STALL_S * 1e9:
                    continue  # stalled: no renewal
                try:
                    await leases.keep_alive(g["id"])
                    log.append(["keep_alive", lid, ms.now_ns()])
                except etcd.EtcdError as e:
                    log.append(["refused", lid, e.kind, ms.now_ns()])
                    return

        async def watcher():
            await ms.sleep(POLL_S)
            c = await etcd.Client.connect([addr])
            seen, gone = set(), {}
            while ms.now_ns() < END_S * 1e9:
                await ms.sleep(POLL_S)
                now = set((await c.lease_client().leases())["leases"])
                for lid in sorted(seen - now):
                    gone.setdefault(lid, ms.now_ns())
                    log.append(["expired", lid, ms.now_ns()])
                seen |= now
            keys = (await c.get("/svc/", etcd.GetOptions(prefix=True)))["kvs"]
            return gone, sorted(now), [kv.key.decode() for kv in keys]

        for i, lid in enumerate(LEASES):
            h.create_node().name(f"client-{lid}").ip(f"10.0.1.{i + 1}").init(
                lambda lid=lid: client(lid)).build()
        w = h.create_node().name("watcher").ip("10.0.2.1").build()
        return await w.spawn(watcher())

    rt = ms.Runtime(seed=seed)
    rt.set_time_limit(END_S + 30.0)
    gone, alive, keys = rt.block_on(main())
    return dict(log=log, expired=gone, alive=alive, keys=keys)


def host_verdict(out: dict) -> tuple:
    """``(expired leases, surviving leases, whole seconds of each
    expiry)`` of one host run."""
    return (sorted(out["expired"]), list(out["alive"]),
            [int(out["expired"][lid] // 1_000_000_000) for lid in sorted(out["expired"])])


def card_verdicts(hist_word, hist_count, op_expire: int, op_watch: int,
                  ok_ok: int, ok_fail: int) -> list:
    """Per seed of a leasekv-record history (numpy ``hist_word`` (S, H,
    5), ``hist_count`` (S,)): ``(expired leases, surviving leases, whole
    seconds of each expiry on the server's clock, leases named by the
    watcher's in-order events)``."""
    out = []
    h = hist_word.shape[1]
    for s in range(hist_word.shape[0]):
        w = hist_word[s, : min(int(hist_count[s]), h)]
        life = w[:, 0] == op_expire
        granted = {int(k) for k in w[life & (w[:, 4] == ok_ok), 1]}
        exp = {int(k): int(a) // 1000 for k, a in zip(w[life & (w[:, 4] == ok_fail), 1],
                                                      w[life & (w[:, 4] == ok_fail), 2])}
        watched = {int(k) for k in w[(w[:, 0] == op_watch) & (w[:, 4] == ok_ok), 1]}
        out.append((sorted(exp), sorted(granted - set(exp)),
                    [exp[lid] for lid in sorted(exp)], sorted(watched)))
    return out


def check_seed(card: tuple, host: tuple) -> str | None:
    """What is wrong with one seed's pair of verdicts, or None."""
    c_exp, c_alive, c_sec, watched = card
    h_exp, h_alive, h_sec = host
    if c_exp != [1] or c_alive != [2, 3] or watched != [1]:
        return f"card: expired {c_exp}, alive {c_alive}, watched {watched}"
    if (h_exp, h_alive) != (c_exp, c_alive):
        return f"host: expired {h_exp}, alive {h_alive}; card {c_exp}, {c_alive}"
    lo, hi = HOST_EXPIRY_S
    if not all(lo <= x <= hi for x in h_sec):
        return f"host expiry seconds {h_sec} outside [{lo}, {hi}]"
    dlo, dhi = CARD_MINUS_HOST_S
    if not all(dlo <= c - x <= dhi for c, x in zip(c_sec, h_sec)):
        return f"card seconds {c_sec} minus host seconds {h_sec} outside [{dlo}, {dhi}]"
    return None
