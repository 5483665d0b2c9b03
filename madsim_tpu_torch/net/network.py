"""Message-level network graph: the core fault model.

Parity with reference madsim/src/sim/net/network.rs:
  * nodes with at most one IP; sockets keyed ``((ip, port), protocol)``
    with 0.0.0.0 wildcard matching (network.rs:24-70, 311-313).
  * per-message faults consulted on every send: clogged-node and
    clogged-link sets, packet loss rate, uniform random latency
    (network.rs:75-95 Config, 169-210 clog API, 268-276 test_link).
  * ephemeral-port allocation when binding port 0 (network.rs:213-258).
  * ``reset_node`` clears the node's sockets — a killed machine loses all
    bindings (network.rs:148-154).
  * ``Stat`` message counter (network.rs:106-111).

The latency/loss draws all flow through the simulation's GlobalRng, so a
partition schedule replays exactly from the seed. The batched engine
(engine/core.py) implements this same model as vectorized arrays over a
seed axis.
"""

from __future__ import annotations

from typing import Optional, Protocol

from ..runtime.config import NetConfig
from ..runtime.rand import GlobalRng
from .addr import SocketAddr

__all__ = ["Network", "Socket", "Stat", "Protocols"]

NANOS_PER_SEC = 1_000_000_000


class Protocols:
    UDP = "udp"
    TCP = "tcp"
    EP = "ep"  # Endpoint tagged datagrams


class Socket(Protocol):
    """Delivery target registered in the network (network.rs:57-70)."""

    def deliver(self, src: SocketAddr, dst: SocketAddr, msg: object) -> None: ...


class Stat:
    """Built-in metrics (network.rs:106-111)."""

    __slots__ = ("msg_count",)

    def __init__(self) -> None:
        self.msg_count = 0

    def __repr__(self) -> str:
        return f"Stat(msg_count={self.msg_count})"


class _NetNode:
    __slots__ = ("id", "ip", "sockets")

    def __init__(self, node_id: int, ip: Optional[str]):
        self.id = node_id
        self.ip = ip
        # (addr, proto) -> Socket
        self.sockets: dict[tuple[SocketAddr, str], Socket] = {}


class Network:
    def __init__(self, rng: GlobalRng, config: NetConfig):
        self.rng = rng
        self.config = config
        self.stat = Stat()
        self._nodes: dict[int, _NetNode] = {}
        self._ip_to_node: dict[str, int] = {}
        self._clogged_nodes: set[int] = set()
        self._clogged_links: set[tuple[int, int]] = set()  # (src, dst) one-way
        self._clogged_in: set[int] = set()   # deliveries TO node blocked
        self._clogged_out: set[int] = set()  # sends FROM node blocked
        # gray failures (madsim_tpu_torch.chaos): per-link latency multipliers;
        # absent = x1. The dict mirrors the batched engine's (N,N) `slow`
        # matrix with OVERWRITE semantics — a node-wide set/unset writes
        # every link touching the node, exactly like the engine's
        # node-wide select (so the same plan yields the same multiplier
        # state in both execution modes, including the case where a
        # node-wide unslow wipes an earlier link-specific multiplier).
        self._slow_links: dict[tuple[int, int], int] = {}  # (src, dst) one-way

    # ---- node lifecycle -------------------------------------------------
    def insert_node(self, node_id: int, ip: Optional[str]) -> None:
        if ip is not None and ip in self._ip_to_node:
            raise ValueError(f"IP {ip} already assigned to node {self._ip_to_node[ip]}")
        self._nodes[node_id] = _NetNode(node_id, ip)
        if ip is not None:
            self._ip_to_node[ip] = node_id

    def reset_node(self, node_id: int) -> None:
        """Clear sockets; the machine rebooted (network.rs:148-154)."""
        node = self._nodes.get(node_id)
        if node is not None:
            node.sockets.clear()

    def set_ip(self, node_id: int, ip: str) -> None:
        node = self._nodes[node_id]
        if node.ip is not None:
            self._ip_to_node.pop(node.ip, None)
        if ip in self._ip_to_node and self._ip_to_node[ip] != node_id:
            raise ValueError(f"IP {ip} already assigned")
        node.ip = ip
        self._ip_to_node[ip] = node_id

    def ip_of(self, node_id: int) -> Optional[str]:
        node = self._nodes.get(node_id)
        return node.ip if node else None

    # ---- fault injection (network.rs:169-210) ---------------------------
    def clog_node(self, node_id: int) -> None:
        self._clogged_nodes.add(node_id)

    def unclog_node(self, node_id: int) -> None:
        self._clogged_nodes.discard(node_id)

    def clog_node_in(self, node_id: int) -> None:
        """Directional clog: messages TO the node blocked (mod.rs:183)."""
        self._clogged_in.add(node_id)

    def unclog_node_in(self, node_id: int) -> None:
        self._clogged_in.discard(node_id)

    def clog_node_out(self, node_id: int) -> None:
        """Directional clog: messages FROM the node blocked (mod.rs:188)."""
        self._clogged_out.add(node_id)

    def unclog_node_out(self, node_id: int) -> None:
        self._clogged_out.discard(node_id)

    def clog_link(self, src: int, dst: int) -> None:
        """Block messages src -> dst (one direction)."""
        self._clogged_links.add((src, dst))

    def unclog_link(self, src: int, dst: int) -> None:
        self._clogged_links.discard((src, dst))

    def set_slow_link(self, src: int, dst: int, mult: int) -> None:
        """Gray failure: multiply src -> dst latency by ``mult`` (one
        direction; mult <= 1 restores normal speed)."""
        if mult > 1:
            self._slow_links[(src, dst)] = int(mult)
        else:
            self._slow_links.pop((src, dst), None)

    def set_slow_node(self, node_id: int, mult: int) -> None:
        """Set every link in or out of the node to ``mult`` (engine
        node-wide overwrite semantics; mult <= 1 restores them all,
        including any link-specific multiplier set earlier)."""
        for other in self._nodes:
            self.set_slow_link(node_id, other, mult)
            self.set_slow_link(other, node_id, mult)

    def slow_mult(self, src: int, dst: int) -> int:
        """Effective latency multiplier for one message."""
        return self._slow_links.get((src, dst), 1)

    def is_clogged(self, src: int, dst: int) -> bool:
        return (
            src in self._clogged_nodes
            or dst in self._clogged_nodes
            or src in self._clogged_out
            or dst in self._clogged_in
            or (src, dst) in self._clogged_links
        )

    # ---- binding (network.rs:213-261) -----------------------------------
    def bind(
        self, node_id: int, addr: SocketAddr, proto: str, socket: Socket
    ) -> SocketAddr:
        node = self._nodes[node_id]
        ip, port = addr
        if port == 0:
            # ephemeral-port allocation: random scan of 0x8000..0xffff
            for _ in range(64):
                cand = self.rng.randrange(0x8000, 0x10000)
                if ((ip, cand), proto) not in node.sockets:
                    port = cand
                    break
            else:
                raise OSError("address space exhausted: no free ephemeral port")
        key = ((ip, port), proto)
        if key in node.sockets:
            raise OSError(f"address already in use: {ip}:{port}/{proto}")
        node.sockets[key] = socket
        return (ip, port)

    def close(self, node_id: int, addr: SocketAddr, proto: str) -> None:
        node = self._nodes.get(node_id)
        if node is not None:
            node.sockets.pop((addr, proto), None)

    # ---- resolution + send (network.rs:268-320) -------------------------
    def resolve_dest_node(self, dst_ip: str, src_node: int) -> Optional[int]:
        """IP -> node id; loopback resolves to the sender's own node
        (localhost isolation, endpoint.rs tests)."""
        if dst_ip in ("127.0.0.1", "localhost"):
            return src_node
        return self._ip_to_node.get(dst_ip)

    def test_link(self, src: int, dst: int) -> Optional[int]:
        """Consult clog + loss + latency for one message. Returns latency
        in ns, or None if the message is dropped (network.rs:268-276).

        Draw order is fixed (loss first, then latency) — part of the
        deterministic trace contract shared with the batched engine."""
        if self.is_clogged(src, dst):
            return None
        cfg = self.config
        if cfg.packet_loss_rate > 0 and self.rng.random_bool(cfg.packet_loss_rate):
            return None
        lo = round(cfg.send_latency[0] * NANOS_PER_SEC)
        hi = round(cfg.send_latency[1] * NANOS_PER_SEC)
        latency = self.rng.randrange(lo, max(hi, lo + 1))
        # gray failure: the drawn latency scales AFTER the draw, so
        # enabling/disabling a slow link never shifts the RNG stream
        # (determinism: the same draws happen either way)
        return latency * self.slow_mult(src, dst)

    def lookup_socket(self, node_id: int, addr: SocketAddr, proto: str) -> Optional[Socket]:
        """Exact-match then 0.0.0.0-wildcard socket lookup on a node
        (network.rs:311-313). Shared by datagram routing and connection
        setup so binding semantics cannot diverge."""
        node = self._nodes.get(node_id)
        if node is None:
            return None
        sock = node.sockets.get((addr, proto))
        if sock is None:
            sock = node.sockets.get((("0.0.0.0", addr[1]), proto))
        return sock

    def try_send(
        self, src_node: int, dst: SocketAddr, proto: str
    ) -> Optional[tuple[Socket, int, int]]:
        """Route one message: returns (socket, dst_node, latency_ns) or
        None if unroutable/clogged/lost (network.rs:303-320)."""
        dst_node = self.resolve_dest_node(dst[0], src_node)
        if dst_node is None or dst_node not in self._nodes:
            return None
        latency = self.test_link(src_node, dst_node)
        if latency is None:
            return None
        sock = self.lookup_socket(dst_node, dst, proto)
        if sock is None:
            return None
        self.stat.msg_count += 1
        return (sock, dst_node, latency)
