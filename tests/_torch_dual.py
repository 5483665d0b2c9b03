"""The runtime side of the dual-mode contract, for either package.

The batched engine runs a fault plan as pre-seeded pool rows; the
single-seed runtime runs the same plan through ``chaos.Nemesis``, and
``check.Recorder`` records the application's history in the engine's
representation, so one checker judges both modes. This module drives the
raft KV example (``examples/raft_kv.py``, or the port's copy
``tests/_torch_raft_kv.py``) on a package's runtime under a plan, with a
``Recorder`` spy on election wins and, optionally, a client whose puts
and gets a second ``Recorder`` keeps. ``chip_smoke.py`` imports it for
its dual-mode phase, so it imports nothing of the JAX package itself:
the package and the application are arguments.
"""

from __future__ import annotations

import importlib

import numpy as np


def _mod(ms, path: str):
    return importlib.import_module(f"{ms.__name__}.{path}")


def event_tuples(events) -> list:
    """``FaultEvent``s as ``(t, kind, a0, a1)`` tuples, in the given order."""
    return [(int(e.t), int(e.kind), int(e.a0), int(e.a1)) for e in events]


def rows_events(rows, s: int) -> list:
    """Seed ``s``'s valid rows of a compiled ``PlanRows`` (numpy or
    torch, on any device) as ``(t, kind, a0, a1)`` in time order; rows
    of one time keep their slot order, as ``Nemesis.events`` sorts."""
    def host(x):
        return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)

    time, kind, args, valid = (host(rows.time)[s], host(rows.kind)[s],
                               host(rows.args)[s], host(rows.valid)[s])
    out = [(int(time[j]), int(kind[j]), int(args[j, 0]), int(args[j, 1]))
           for j in range(time.shape[0]) if bool(valid[j])]
    return sorted(out, key=lambda e: e[0])


def nemesis_events(ms, plan, seed: int, n_nodes: int = 5) -> list:
    """``Nemesis(plan).events()`` inside ``ms.Runtime(seed=seed)`` with
    ``n_nodes`` nodes created first, as ``(t, kind, a0, a1)``."""
    chaos = _mod(ms, "chaos")
    rt = ms.Runtime(seed=seed)
    for _ in range(n_nodes):
        rt.create_node().build()

    async def main():
        return chaos.Nemesis(plan).events()

    return event_tuples(rt.block_on(main()))


def history_rows(rec) -> list:
    """A Recorder's rows as ``[op, key, arg, client, ok, t]`` lists."""
    h = rec.to_batch()
    n = int(h.count[0])
    return [[*map(int, h.word[0, i]), int(h.t[0, i])] for i in range(n)]


# the packet loss of every cluster run: the engine side's ``loss_p``
LOSS = 0.02


def raft_cluster(ms, app, seed: int, plan=None, seconds: float = 2.0,
                 persist: bool = True, client: bool = False) -> dict:
    """Run ``app``'s five-peer cluster on ``ms.Runtime(seed=seed)`` with
    ``cfg.net.packet_loss_rate = LOSS`` for ``seconds`` of simulated time
    (or until the client is done, if later), under ``Nemesis(plan)``.

    Returns ``elect`` (the election Recorder), ``elect_rows``, ``log``
    (the nemesis's applied ``(t_applied, t, kind, a0, a1)``), ``events``
    (its compiled events) and, with ``client``, ``kv`` and ``kv_rows``,
    the client's puts and gets. ``persist=False`` stubs out the peers'
    ``save``/``load``, as the JAX package's convergence test does."""
    chaos, check = _mod(ms, "chaos"), _mod(ms, "check")
    op_elect = _mod(ms, "models.raft").OP_ELECT
    elect, kv = check.Recorder(), check.Recorder()

    class Spy(app.ClusterMonitor):
        def note_leader(self, term, who):
            elect.event(client=who, op=op_elect, key=term, arg=who)
            super().note_leader(term, who)

    monitor = Spy()
    out = {"elect": elect, "log": [], "events": []}

    async def client_ops():
        ep = await app.Endpoint.bind("0.0.0.0:0")
        for i in range(4):
            key, val = i % 3, 10 + i
            tok = kv.invoke(client=0, op=check.OP_WRITE, key=key, arg=val)
            try:
                await app.client_put(ep, f"k{key}", val)
                kv.respond(tok, ok=True, value=val)
            except TimeoutError:
                kv.respond(tok, ok=False, value=val)
            tok = kv.invoke(client=0, op=check.OP_READ, key=key)
            try:
                v = await app.client_get(ep, f"k{key}")
                kv.respond(tok, ok=True, value=0 if v is None else v)
            except TimeoutError:
                kv.respond(tok, ok=False)

    async def main():
        h = ms.Handle.current()
        app.spawn_cluster(h, monitor)
        if plan is not None:
            nem = chaos.Nemesis(plan)
            out["events"] = event_tuples(nem.events())
            out["nemesis"] = nem
            ms.spawn(nem.run(), name="nemesis")
        done = None
        if client:
            node = h.create_node().name("client").ip("10.0.9.9").build()
            done = node.spawn(client_ops(), name="client")
        await ms.sleep(seconds)
        if done is not None:
            await done

    cfg = ms.Config()
    cfg.net.packet_loss_rate = LOSS
    saved = (app.RaftPeer.save, app.RaftPeer.load)
    if not persist:
        async def nothing(self):
            return None

        app.RaftPeer.save = app.RaftPeer.load = nothing
    try:
        ms.Runtime(seed=seed, config=cfg).block_on(main())
    finally:
        app.RaftPeer.save, app.RaftPeer.load = saved
    nem = out.pop("nemesis", None)
    if nem is not None:
        out["log"] = [(int(t), *event_tuples([ev])[0]) for t, ev in nem.log]
    out["elect_rows"] = history_rows(elect)
    if client:
        out["kv"] = kv
        out["kv_rows"] = history_rows(kv)
    return out


def election_verdict(ms, rec) -> bool:
    """``election_safety`` of one Recorder's history."""
    check = _mod(ms, "check")
    op_elect = _mod(ms, "models.raft").OP_ELECT
    return bool(check.election_safety(rec.to_batch(), elect_op=op_elect)[0])
