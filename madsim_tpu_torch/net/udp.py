"""UDP socket simulator — a thin veneer over Endpoint tag 0.

Parity with reference madsim/src/sim/net/udp.rs:9-73: bind / connect /
send_to / recv_from with datagram loss/latency/partition semantics
inherited from the network fault model.
"""

from __future__ import annotations

from typing import Optional

from .addr import AddrLike, SocketAddr, parse_addr
from .endpoint import Endpoint
from .network import Protocols

__all__ = ["UdpSocket"]

_UDP_TAG = 0


class UdpSocket:
    def __init__(self, ep: Endpoint):
        self._ep = ep
        self._peer: Optional[SocketAddr] = None

    @classmethod
    async def bind(cls, addr: AddrLike) -> "UdpSocket":
        # Own protocol namespace: coexists with TCP/Endpoint on a port.
        return cls(await Endpoint.bind(addr, _proto=Protocols.UDP))

    @property
    def local_addr(self) -> SocketAddr:
        return self._ep.local_addr

    async def send_to(self, data: bytes, addr: AddrLike) -> int:
        await self._ep.send_to(addr, _UDP_TAG, bytes(data))
        return len(data)

    async def recv_from(self) -> tuple[bytes, SocketAddr]:
        payload, src = await self._ep.recv_from(_UDP_TAG)
        return payload, src

    async def connect(self, addr: AddrLike) -> None:
        self._peer = parse_addr(addr)

    async def send(self, data: bytes) -> int:
        if self._peer is None:
            raise OSError("UdpSocket.send before connect")
        return await self.send_to(data, self._peer)

    async def recv(self) -> bytes:
        if self._peer is None:
            raise OSError("UdpSocket.recv before connect")
        while True:
            payload, src = await self.recv_from()
            if src == self._peer:
                return payload

    @property
    def peer_addr(self) -> Optional[SocketAddr]:
        return self._peer

    def close(self) -> None:
        """Release the port binding (sockets are per-node resources)."""
        self._ep.close()
