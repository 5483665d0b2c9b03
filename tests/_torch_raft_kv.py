"""A replicated raft KV store on the port's single-seed runtime.

The port's copy of ``examples/raft_kv.py``, held against it by
``tests/test_torch_dual_mode.py`` and driven by ``chip_smoke.py``'s
dual-mode raft hunt. It imports ``madsim_tpu_torch`` and nothing of the
JAX package; the protocol is the example's, line for line:

- RPC via the ``@service``/``@rpc`` decorators over ``Endpoint``
  (net/service.py),
- randomized election timeouts from the interposed stdlib ``random``
  (deterministic per seed, runtime/intercept.py),
- persistent (currentTerm, votedFor, log[]) written through the
  simulated fs with ``sync_all``: node kills roll unsynced writes back
  (fs.py power-fail semantics), so raft's crash-recovery argument rests
  on real fsync points,
- chaos from the supervisor: ``Handle.kill``/``restart`` replay the
  node's init task, which reloads state from disk.

Run it:  MADSIM_TEST_SEED=1 PYTHONPATH=. python tests/_torch_raft_kv.py
"""

import pickle
import random

import madsim_tpu_torch as ms
from madsim_tpu_torch import check, fs
from madsim_tpu_torch.net import Endpoint
from madsim_tpu_torch.net.service import rpc, service
from madsim_tpu_torch.runtime import Elapsed

__all__ = [
    "RaftPeer", "ClusterMonitor", "spawn_cluster", "spawn_server",
    "client_put", "client_get", "client_add_server",
    "client_remove_server", "N_PEERS", "peer_addr",
]

N_PEERS = 5
PORT = 9100
ELECTION_TIMEOUT = (0.15, 0.30)   # s, randomized per wait (raft §5.2)
HEARTBEAT = 0.05                  # s
STATE_FILE = "raft_state"


def peer_ip(i: int) -> str:
    return f"10.0.1.{i + 1}"


def peer_addr(i: int) -> str:
    return f"{peer_ip(i)}:{PORT}"


# ---------------------------------------------------------------- messages
class RequestVote:
    def __init__(self, term, candidate, last_log_idx, last_log_term):
        self.term = term
        self.candidate = candidate
        self.last_log_idx = last_log_idx
        self.last_log_term = last_log_term


class VoteReply:
    def __init__(self, term, granted):
        self.term = term
        self.granted = granted


class AppendEntries:
    def __init__(self, term, leader, prev_idx, prev_term, entries, commit):
        self.term = term
        self.leader = leader
        self.prev_idx = prev_idx
        self.prev_term = prev_term
        self.entries = entries      # list[(term, cmd)]; cmd = (op, key, val)
        self.commit = commit


class AppendReply:
    def __init__(self, term, ok, match_idx):
        self.term = term
        self.ok = ok
        self.match_idx = match_idx


class ClientPut:
    def __init__(self, key, val):
        self.key = key
        self.val = val


class ClientGet:
    def __init__(self, key):
        self.key = key


class AddServer:
    """Single-server membership change (Ongaro thesis §4.1): add sid to
    the cluster config. One change at a time."""

    def __init__(self, sid):
        self.sid = sid


class RemoveServer:
    def __init__(self, sid):
        self.sid = sid


class Redirect:
    """Not the leader; carries a hint (the reference pattern: clients
    probe the cluster, tonic-example drives a fixed address)."""

    def __init__(self, hint):
        self.hint = hint


class ClusterMonitor:
    """Test instrumentation shared across nodes (the analog of the
    reference tests' static atomics, tonic-example/src/server.rs:283)."""

    def __init__(self):
        self.leaders_by_term: dict[int, set[int]] = {}
        self.peers: dict[int, "RaftPeer"] = {}

    def note_leader(self, term: int, who: int) -> None:
        self.leaders_by_term.setdefault(term, set()).add(who)


# ---------------------------------------------------------------- the peer
@service
class RaftPeer:
    """One raft peer. All state transitions run on the node's
    single-threaded executor; awaits are the only interleave points, so
    handler bodies between awaits are atomic."""

    def __init__(self, me: int, monitor: ClusterMonitor):
        self.me = me
        self.monitor = monitor
        # persistent (raft fig. 2): reloaded by load() on restart
        self.term = 0
        self.voted_for = None
        self.log = []               # [(term, cmd)]; 1-based indexing helpers
        # volatile
        self.role = "follower"
        self.commit = 0
        self.applied = 0
        self.kv = {}
        self.leader_hint = None
        self.heard_from_leader = False
        self.last_leader_ns = -(10 ** 18)   # leader-stickiness guard clock
        self.cfg_idx = 0            # index of the latest config entry (0=none)
        self.apply_waiters = {}     # log idx -> (term, SimFuture)
        monitor.peers[me] = self

    # ---- persistence (fsync-durable; kills roll back unsynced writes)
    async def save(self) -> None:
        f = await fs.File.open_or_create(STATE_FILE)
        blob = pickle.dumps((self.term, self.voted_for, self.log))
        await f.set_len(0)
        await f.write_all_at(blob, 0)
        await f.sync_all()

    async def load(self) -> None:
        try:
            blob = await fs.read(STATE_FILE)
        except FileNotFoundError:
            return
        if blob:
            self.term, self.voted_for, self.log = pickle.loads(blob)
            self.cfg_idx = self._scan_cfg()

    # ---- log helpers (1-based: index 0 is the empty sentinel)
    def last_idx(self) -> int:
        return len(self.log)

    def term_at(self, idx: int) -> int:
        return self.log[idx - 1][0] if 1 <= idx <= len(self.log) else 0

    def up_to_date(self, m: RequestVote) -> bool:
        mine = (self.term_at(self.last_idx()), self.last_idx())
        return (m.last_log_term, m.last_log_idx) >= mine

    # ---- membership (single-server changes, Ongaro thesis §4.1-4.2).
    # A server uses the LATEST config entry in its log, committed or
    # not; configs are ordinary log entries ("config", members). The
    # latest config index is cached (cfg_idx) so the hot paths
    # (heartbeat, campaign) stay O(1) instead of rescanning the log.
    def _scan_cfg(self) -> int:
        for i in range(self.last_idx(), 0, -1):
            if self.log[i - 1][1][0] == "config":
                return i
        return 0

    def _log_append(self, entry) -> None:
        self.log.append(entry)
        if entry[1][0] == "config":
            self.cfg_idx = len(self.log)

    def _log_truncate(self, from_idx: int) -> None:
        """Delete entries from 1-based ``from_idx`` onward."""
        del self.log[from_idx - 1:]
        if self.cfg_idx >= from_idx:
            self.cfg_idx = self._scan_cfg()

    def config_at(self, idx: int) -> frozenset:
        if self.cfg_idx and self.cfg_idx <= idx:
            return frozenset(self.log[self.cfg_idx - 1][1][1])
        # rare: asking below a config entry still in flight above idx
        for i in range(min(idx, self.last_idx()), 0, -1):
            cmd = self.log[i - 1][1]
            if cmd[0] == "config":
                return frozenset(cmd[1])
        return frozenset(range(N_PEERS))

    def current_config(self) -> frozenset:
        if self.cfg_idx:
            return frozenset(self.log[self.cfg_idx - 1][1][1])
        return frozenset(range(N_PEERS))

    def config_pending(self) -> bool:
        """An uncommitted config entry forbids another change."""
        return any(
            self.log[i - 1][1][0] == "config"
            for i in range(self.commit + 1, self.last_idx() + 1)
        )

    def become_follower(self, term: int) -> None:
        # one vote per term: votedFor only resets when the term advances
        # (a same-term step-down — candidate hearing the term's leader —
        # must keep its vote, raft fig. 2)
        if term != self.term:
            self.voted_for = None
        self.term = term
        self.role = "follower"

    # ---- RPC handlers
    @rpc
    async def request_vote(self, m: RequestVote):
        # Leader stickiness (thesis §4.2.3): while we believe a current
        # leader exists — we ARE it, or we heard one within the minimum
        # election timeout — DISREGARD RequestVote entirely, no term
        # update. This is what makes removed servers non-disruptive:
        # their rising terms cannot depose a working leader (a
        # partitioned stale leader still steps down via the higher term
        # on AppendEntries replies once it reaches a member).
        if self.role == "leader" \
                or ms.now_ns() - self.last_leader_ns < int(ELECTION_TIMEOUT[0] * 1e9):
            return VoteReply(self.term, False)
        if m.term > self.term:
            self.become_follower(m.term)
            await self.save()
        granted = (
            m.term == self.term
            and self.voted_for in (None, m.candidate)
            and self.up_to_date(m)
        )
        if granted:
            self.voted_for = m.candidate
            self.heard_from_leader = True   # reset election timer on grant
            await self.save()
        return VoteReply(self.term, granted)

    @rpc
    async def append_entries(self, m: AppendEntries):
        if m.term < self.term:
            return AppendReply(self.term, False, 0)
        if m.term > self.term or self.role != "follower":
            self.become_follower(m.term)
            await self.save()
        self.heard_from_leader = True
        self.last_leader_ns = ms.now_ns()
        self.leader_hint = m.leader
        if m.prev_idx > self.last_idx() or self.term_at(m.prev_idx) != m.prev_term:
            return AppendReply(self.term, False, 0)
        # truncate conflicts, append the rest (raft fig. 2 AppendEntries 3-4)
        changed = False
        for k, ent in enumerate(m.entries):
            idx = m.prev_idx + 1 + k
            if idx <= self.last_idx():
                if self.term_at(idx) != ent[0]:
                    self._log_truncate(idx)
                    self._log_append(ent)
                    changed = True
            else:
                self._log_append(ent)
                changed = True
        if changed:
            await self.save()
        match = m.prev_idx + len(m.entries)
        if m.commit > self.commit:
            self.commit = min(m.commit, self.last_idx())
            self.apply_committed()
        return AppendReply(self.term, True, match)

    @rpc
    async def client_put(self, m: ClientPut):
        if self.role != "leader":
            return Redirect(self.leader_hint)
        self._log_append((self.term, ("put", m.key, m.val)))
        idx = self.last_idx()
        await self.save()
        fut = ms.SimFuture(name=f"apply-{idx}")
        # key the waiter by (index, term): if this entry is truncated by
        # a new leader and a DIFFERENT entry commits at idx, the waiter
        # must NOT ack — it resolves to a Redirect so the client retries
        self.apply_waiters[idx] = (self.term, fut)
        return await fut            # resolves when committed+applied

    @rpc
    async def client_get(self, m: ClientGet):
        # leader-local read after a committed no-op would be the
        # linearizable form; committed-state read is what the tests
        # assert against (they only read after quiescence)
        if self.role != "leader":
            return Redirect(self.leader_hint)
        return self.kv.get(m.key)

    @rpc
    async def add_server(self, m: AddServer):
        return await self._reconfig(lambda c: c | {m.sid})

    @rpc
    async def remove_server(self, m: RemoveServer):
        return await self._reconfig(lambda c: c - {m.sid})

    async def _reconfig(self, f):
        """Append a single-server config change; reply once committed
        (thesis §4.1: one uncommitted change at a time)."""
        if self.role != "leader":
            return Redirect(self.leader_hint)
        if self.config_pending():
            return Redirect(self.me)    # change in flight; client retries
        new = frozenset(f(self.current_config()))
        if not new or new == self.current_config():
            return "ok"                 # no-op change
        self._log_append((self.term, ("config", tuple(sorted(new)))))
        idx = self.last_idx()
        await self.save()
        fut = ms.SimFuture(name=f"cfg-{idx}")
        self.apply_waiters[idx] = (self.term, fut)
        return await fut

    # ---- apply
    def apply_committed(self) -> None:
        while self.applied < self.commit:
            self.applied += 1
            t, cmd = self.log[self.applied - 1]
            if cmd[0] == "put":
                _, key, val = cmd
                self.kv[key] = val
                result = val
            else:                       # ("config", members): no kv effect
                result = "ok"
            entry = self.apply_waiters.pop(self.applied, None)
            if entry is not None:
                waited_term, w = entry
                if not w.done():
                    if waited_term == t:
                        w.set_result(result)
                    else:
                        # the entry the client appended was replaced —
                        # its write did NOT commit; make the client retry
                        w.set_result(Redirect(self.leader_hint))

    # ---- roles
    async def run(self) -> None:
        """The node's init task: restart re-enters here and load()
        restores the synced persistent state (crash recovery)."""
        await self.load()
        ep = await self.serve(f"0.0.0.0:{PORT}")
        while True:
            if self.role == "leader":
                await self.lead(ep)
            else:
                await self.follow(ep)

    async def follow(self, ep: Endpoint) -> None:
        self.heard_from_leader = False
        await ms.sleep(random.uniform(*ELECTION_TIMEOUT))
        if self.heard_from_leader:
            return
        if self.me not in self.current_config():
            return      # a non-member never campaigns (thesis §4.2.2)
        await self.campaign(ep)

    async def campaign(self, ep: Endpoint) -> None:
        self.role = "candidate"
        self.term += 1
        self.voted_for = self.me
        await self.save()
        term = self.term
        members = self.current_config()
        req = RequestVote(term, self.me, self.last_idx(),
                          self.term_at(self.last_idx()))
        votes = 1       # self (campaign is members-only)

        async def ask(i):
            try:
                return await ep.call(peer_addr(i), req, timeout=0.1)
            except Elapsed:
                return None

        pending = [ms.spawn(ask(i)) for i in sorted(members) if i != self.me]
        for h in pending:
            r = await h
            if r is None or self.term != term or self.role != "candidate":
                continue
            if r.term > self.term:
                self.become_follower(r.term)
                await self.save()
                return
            if r.granted:
                votes += 1
        if self.role == "candidate" and self.term == term \
                and votes * 2 > len(members):
            self.role = "leader"
            self.leader_hint = self.me
            self.monitor.note_leader(term, self.me)
            self.next_idx = {}
            self.match_idx = {}
            # current-term no-op (raft §8 / thesis §3.6.1): lets the
            # leader commit prior-term entries — without it, an
            # uncommitted config entry inherited from a dead leader
            # would wedge reconfiguration until an unrelated client put
            self._log_append((self.term, ("noop",)))
            await self.save()

    async def lead(self, ep: Endpoint) -> None:
        term = self.term
        members = self.current_config()

        async def replicate(i):
            prev = self.next_idx.setdefault(i, self.last_idx() + 1) - 1
            entries = self.log[prev:]
            req = AppendEntries(term, self.me, prev, self.term_at(prev),
                                entries, self.commit)
            try:
                r = await ep.call(peer_addr(i), req, timeout=0.1)
            except Elapsed:
                return
            if self.term != term or self.role != "leader":
                return
            if r.term > self.term:
                self.become_follower(r.term)
                await self.save()
                return
            if r.ok:
                self.match_idx[i] = max(self.match_idx.get(i, 0), r.match_idx)
                self.next_idx[i] = self.match_idx[i] + 1
            else:
                self.next_idx[i] = max(1, self.next_idx[i] - 1)

        for i in sorted(members):
            if i != self.me:
                ms.spawn(replicate(i))
        # leader commit rule: majority of the CURRENT config matches AND
        # the entry is from the current term
        for n in range(self.last_idx(), self.commit, -1):
            if self.term_at(n) != self.term:
                break
            count = (1 if self.me in members else 0) + sum(
                1 for i in members
                if i != self.me and self.match_idx.get(i, 0) >= n
            )
            if count * 2 > len(members):
                self.commit = n
                self.apply_committed()
                break
        # a leader removed by a now-COMMITTED config steps down
        # (thesis §4.2.2)
        if self.me not in self.config_at(self.commit):
            self.role = "follower"
            return
        await ms.sleep(HEARTBEAT)


# ---------------------------------------------------------------- harness
def spawn_server(h, monitor: ClusterMonitor, i: int):
    """One raft server node (also used to bring up NEW servers joining
    via AddServer)."""
    async def init():
        await RaftPeer(i, monitor).run()

    return (
        h.create_node().name(f"raft-{i}").ip(peer_ip(i))
        .init(init).build()
    )


def spawn_cluster(h, monitor: ClusterMonitor):
    """Create the 5 initial peer nodes; returns their NodeHandles
    (kill/restart them through the supervisor, tonic-example
    server_crash pattern)."""
    return [spawn_server(h, monitor, i) for i in range(N_PEERS)]


async def _client_call(ep: Endpoint, req, retries: int = 60, servers=None):
    """Probe for the leader with redirects + retries (clients outlive
    elections, leader crashes and reconfigurations)."""
    servers = list(servers) if servers is not None else list(range(N_PEERS))
    hint = None
    for _ in range(retries):
        order = [hint] if hint is not None else []
        order += [i for i in servers if i != hint]
        for i in order:
            try:
                r = await ep.call(peer_addr(i), req, timeout=0.25)
            except Elapsed:
                continue
            if isinstance(r, Redirect):
                hint = r.hint
                continue
            return r
        await ms.sleep(0.1)
    raise TimeoutError(f"no leader answered {type(req).__name__}")


async def client_put(ep: Endpoint, key, val, servers=None):
    return await _client_call(ep, ClientPut(key, val), servers=servers)


async def client_get(ep: Endpoint, key, servers=None):
    return await _client_call(ep, ClientGet(key), servers=servers)


async def client_add_server(ep: Endpoint, sid, servers=None):
    return await _client_call(ep, AddServer(sid), servers=servers)


async def client_remove_server(ep: Endpoint, sid, servers=None):
    return await _client_call(ep, RemoveServer(sid), servers=servers)


@ms.main
async def main():
    h = ms.Handle.current()
    monitor = ClusterMonitor()
    nodes = spawn_cluster(h, monitor)
    client = h.create_node().name("client").ip("10.0.9.9").build()

    # the same operation-history checker that validates the batched
    # engine's recorded histories (madsim_tpu_torch.check) validates this
    # asyncio-level app: record every client op, Wing–Gong check at end
    rec = check.Recorder()
    key_ids = {"a": 0, "b": 1, "c": 2}

    async def put(ep, key, val):
        tok = rec.invoke(client=0, op=check.OP_WRITE,
                         key=key_ids[key], arg=val)
        r = await client_put(ep, key, val)
        rec.respond(tok, ok=True, value=val)
        return r

    async def get(ep, key):
        tok = rec.invoke(client=0, op=check.OP_READ, key=key_ids[key])
        v = await client_get(ep, key)
        rec.respond(tok, ok=True, value=0 if v is None else v)
        return v

    async def run():
        ep = await Endpoint.bind("0.0.0.0:0")
        await put(ep, "a", 1)
        await put(ep, "b", 2)
        print(f"t={ms.now_ns()/1e9:.3f}s  put a=1 b=2 committed")
        # crash the current leader, cluster must recover and keep data
        lead_term = max(monitor.leaders_by_term)
        (who,) = monitor.leaders_by_term[lead_term]
        h.kill(nodes[who])
        print(f"t={ms.now_ns()/1e9:.3f}s  killed leader raft-{who}")
        await put(ep, "c", 3)
        assert await get(ep, "a") == 1
        assert await get(ep, "c") == 3
        h.restart(nodes[who])
        print(f"t={ms.now_ns()/1e9:.3f}s  new leader serving; a=1 c=3 intact")
        for term in sorted(monitor.leaders_by_term):
            assert len(monitor.leaders_by_term[term]) <= 1, "election safety"
        print("election safety held:",
              {t: sorted(w) for t, w in monitor.leaders_by_term.items()})
        lin = rec.check_kv()
        assert lin.ok, f"client history not linearizable: {lin.reason}"
        print(f"client history linearizable: {lin.n_ops} ops "
              f"(madsim_tpu_torch.check.Recorder)")

    await client.spawn(run())


if __name__ == "__main__":
    main()
