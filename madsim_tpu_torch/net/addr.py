"""Deterministic address parsing/resolution.

Parity with reference madsim/src/sim/net/addr.rs: a synchronous,
deterministic resolver — no real DNS. ``"localhost"`` maps to 127.0.0.1
(addr.rs:1-80); accepted forms are ``"ip:port"`` strings, ``(ip, port)``
tuples, and already-parsed :class:`SocketAddr`.
"""

from __future__ import annotations

from typing import Iterable, Tuple, Union

__all__ = ["SocketAddr", "parse_addr", "lookup_host", "AddrLike"]

SocketAddr = Tuple[str, int]
AddrLike = Union[str, SocketAddr]

_ALIASES = {"localhost": "127.0.0.1", "": "0.0.0.0", "*": "0.0.0.0"}


def _canon_ip(ip: str) -> str:
    return _ALIASES.get(ip, ip)


def parse_addr(addr: AddrLike) -> SocketAddr:
    """Parse an address into a canonical ``(ip, port)`` tuple."""
    if isinstance(addr, tuple):
        ip, port = addr
        return (_canon_ip(str(ip)), int(port))
    if isinstance(addr, str):
        if ":" not in addr:
            raise ValueError(f"invalid socket address {addr!r}: expected 'ip:port'")
        host, _, port_s = addr.rpartition(":")
        return (_canon_ip(host), int(port_s))
    raise TypeError(f"cannot parse address from {type(addr).__name__}")


def _is_ip_literal(s: str) -> bool:
    return bool(s) and not any(c.isalpha() for c in s)


async def lookup_host(host: AddrLike) -> Iterable[SocketAddr]:
    """Deterministic hostname resolution (addr.rs:32): never touches
    real DNS. IP literals (plus the localhost aliases) canonicalize;
    inside a simulation, a non-IP name resolves to the simulated node
    with that name (the node registry IS the zone file — beyond the
    reference's alias-only resolver), so services connect by name:
    ``asyncio.open_connection("kv-server", 7000)``. An unknown name
    raises OSError like a real resolver."""
    ip, port = parse_addr(host)
    if _is_ip_literal(ip):
        return [(ip, port)]
    from ..runtime import context

    h = context.try_current_handle()
    if h is not None:
        for info in h.executor.nodes.values():
            if info.name == ip and info.ip:
                return [(info.ip, port)]
    raise OSError(f"name resolution failed for {ip!r}")
