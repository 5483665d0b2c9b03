"""Nemesis: drive a FaultPlan on the single-seed asyncio runtime.

The batched engine executes fault plans as pre-seeded pool rows
(engine/core.py); this module is the dual-mode twin — the same
:class:`~madsim_tpu_torch.chaos.plan.FaultPlan`, compiled for the runtime's
seed into the same concrete event list, applied at the same virtual
times through the public chaos surface: ``Handle.kill/restart/pause/
resume``, ``NetSim.clog_*``/``slow_link``/``set_duplicate``, and
``Handle.set_clock_skew``. A workload checked in both execution modes
therefore faces the *same* fault trajectory in both (dual-mode parity
at the event level; timing within events follows each mode's own
latency model).

Usage, from inside ``Runtime.block_on``::

    nemesis = Nemesis(plan)          # seed defaults to the runtime's
    task = spawn(nemesis.run())      # or: await nemesis.run()
    ...
    print(nemesis.log)               # [(t_ns, FaultEvent), ...] applied
"""

from __future__ import annotations

from ..engine.core import (
    KIND_CLOG,
    KIND_CLOG_1W,
    KIND_CLOG_NODE,
    KIND_DUP_OFF,
    KIND_DUP_ON,
    KIND_KILL,
    KIND_PAUSE,
    KIND_RESTART,
    KIND_RESUME,
    KIND_SKEW,
    KIND_SLOW_LINK,
    KIND_SYNC_LOSS,
    KIND_SYNC_OK,
    KIND_TORN_OFF,
    KIND_TORN_ON,
    KIND_UNCLOG,
    KIND_UNCLOG_1W,
    KIND_UNCLOG_NODE,
    KIND_UNSLOW,
)
from ..runtime import context
from .plan import FaultEvent

__all__ = ["Nemesis"]


class Nemesis:
    """Applies a compiled fault plan to the current simulation.

    ``nodes`` optionally maps plan node indices to runtime node ids (or
    NodeHandles); by default plan node ``i`` is the ``i``-th CREATED
    node in creation order (runtime ids start at 1 — id 0 is the main
    supervisor node, which the engine's node axis does not model and
    which cannot be killed)."""

    def __init__(self, plan, handle=None, nodes=None, seed=None):
        self._plan = plan
        self._handle = handle
        self._nodes = list(nodes) if nodes is not None else None
        self._seed = seed
        self.log: list[tuple[int, FaultEvent]] = []

    def _resolve_handle(self):
        return self._handle if self._handle is not None else context.current_handle()

    def _node(self, handle, i: int):
        if self._nodes is not None:
            node = self._nodes[i]
            return node if isinstance(node, int) else node.id
        from ..runtime.task import MAIN_NODE_ID

        # default: plan node i = the i-th created node, creation order
        # (ids are allocated sequentially from 1; the main node is the
        # supervisor, not a plan target)
        ids = sorted(n for n in handle.executor.nodes if n != MAIN_NODE_ID)
        if i >= len(ids):
            raise ValueError(
                f"plan targets node index {i} but the runtime has only "
                f"{len(ids)} created node(s); pass nodes= to map "
                f"plan indices explicitly"
            )
        return ids[i]

    def _targets(self, handle, i: int) -> list:
        """Resolve a fault target to runtime node ids: the disk-fault
        kinds allow ``-1`` = every node (engine/core.py 242-248), which
        must broadcast here too — Python negative indexing through
        ``_node`` would silently hit only the LAST created node and
        break dual-mode parity."""
        if i >= 0:
            return [self._node(handle, i)]
        if self._nodes is not None:
            return [n if isinstance(n, int) else n.id for n in self._nodes]
        from ..runtime.task import MAIN_NODE_ID

        return sorted(n for n in handle.executor.nodes if n != MAIN_NODE_ID)

    def events(self) -> list[FaultEvent]:
        """The concrete trajectory this nemesis will apply, time order."""
        handle = self._resolve_handle()
        seed = self._seed if self._seed is not None else handle.seed
        return sorted(self._plan.compile(int(seed)), key=lambda e: e.t)

    async def run(self) -> list[tuple[int, FaultEvent]]:
        """Sleep-and-inject every plan event; returns the applied log."""
        handle = self._resolve_handle()
        time = handle.time
        for ev in self.events():
            if ev.t > time.now_ns():
                await time.sleep_until_ns(ev.t)
            self._apply(handle, ev)
            self.log.append((time.now_ns(), ev))
        return self.log

    def _apply(self, handle, ev: FaultEvent) -> None:
        from ..engine.core import FIRST_EXT_KIND, FIRST_USER_KIND
        from ..net.netsim import NetSim

        if FIRST_USER_KIND <= ev.kind < FIRST_EXT_KIND:
            raise ValueError(
                f"nemesis cannot apply user kind {ev.kind}: client-army "
                f"ops (chaos.ClientArmy) are a batched-engine load "
                f"surface — and any chaos.RetryPolicy attached to one is "
                f"a batched-engine timer (engine.RetrySpec), not an "
                f"injectable event; on the asyncio runtime drive load "
                f"(and retries) with real client tasks instead"
            )
        netsim = handle.simulator(NetSim)
        # dup toggles carry no node; disk-fault kinds resolve their own
        # targets (a0 may be -1 = every node)
        a = self._node(handle, ev.a0) if ev.kind not in (
            KIND_DUP_ON, KIND_DUP_OFF, KIND_SYNC_LOSS, KIND_SYNC_OK,
            KIND_TORN_ON, KIND_TORN_OFF,
        ) else 0
        if ev.kind == KIND_KILL:
            handle.kill(a)
        elif ev.kind == KIND_RESTART:
            handle.restart(a)
        elif ev.kind == KIND_PAUSE:
            handle.pause(a)
        elif ev.kind == KIND_RESUME:
            handle.resume(a)
        elif ev.kind == KIND_CLOG:
            netsim.clog_link(a, self._node(handle, ev.a1))
        elif ev.kind == KIND_UNCLOG:
            netsim.unclog_link(a, self._node(handle, ev.a1))
        elif ev.kind == KIND_CLOG_NODE:
            netsim.clog_node(a)
        elif ev.kind == KIND_UNCLOG_NODE:
            netsim.unclog_node(a)
        elif ev.kind == KIND_CLOG_1W:
            netsim.clog_link_one_way(a, self._node(handle, ev.a1))
        elif ev.kind == KIND_UNCLOG_1W:
            netsim.unclog_link_one_way(a, self._node(handle, ev.a1))
        elif ev.kind in (KIND_SLOW_LINK, KIND_UNSLOW):
            from ..engine.core import unpack_slow_arg

            b, mult = unpack_slow_arg(ev.a1)
            mult = max(mult, 1) if ev.kind == KIND_SLOW_LINK else 1
            if b < 0:
                netsim.slow_node(a, mult)
            else:
                netsim.slow_link(a, self._node(handle, b), mult)
        elif ev.kind == KIND_DUP_ON:
            netsim.set_duplicate(True)
        elif ev.kind == KIND_DUP_OFF:
            netsim.set_duplicate(False)
        elif ev.kind == KIND_SKEW:
            handle.set_clock_skew(a, ev.a1)
        elif ev.kind in (KIND_SYNC_LOSS, KIND_SYNC_OK):
            # storage faults land on FsSim — the dual of the engine's
            # sync-discipline state (fs.py injectable-fault hooks).
            # a1 is the window mode: 0 = silent lie (sync_all lies),
            # 1 = observable EIO (writes raise OSError(EIO), the dual
            # of the engine's ctx.sync_err). SYNC_OK ends both.
            from ..fs import FsSim

            sim = handle.simulator(FsSim)
            on = ev.kind == KIND_SYNC_LOSS
            eio = bool(ev.a1 == 1)
            for nid in self._targets(handle, ev.a0):
                if not on:
                    sim.set_sync_loss(nid, False)
                    sim.set_fail_writes(nid, False)
                elif eio:
                    sim.set_fail_writes(nid, True)
                else:
                    sim.set_sync_loss(nid, True)
        elif ev.kind in (KIND_TORN_ON, KIND_TORN_OFF):
            from ..fs import FsSim

            sim = handle.simulator(FsSim)
            for nid in self._targets(handle, ev.a0):
                sim.set_torn(nid, ev.kind == KIND_TORN_ON)
        else:
            raise ValueError(f"nemesis cannot apply kind {ev.kind}")
