"""Simulation configuration.

Parity with reference madsim/src/sim/config.rs: a small typed config
(``{net, tcp}``, config.rs:15-23) that can be parsed from TOML
(config.rs:35-48) and hashed stably (config.rs:27-31) so a failing test can
print a full repro recipe of ``seed + config hash``
(reference sim/runtime/mod.rs:193-200).
"""

from __future__ import annotations

import dataclasses
import hashlib

try:
    import tomllib  # Python 3.11+
except ImportError:  # 3.10: the installed tomli backport is API-identical
    import tomli as tomllib

from dataclasses import dataclass, field

__all__ = ["NetConfig", "TcpConfig", "Config"]


@dataclass
class NetConfig:
    """Network fault model (reference sim/net/network.rs:75-95).

    * ``packet_loss_rate`` — probability each message is dropped.
    * ``send_latency`` — (min_s, max_s) uniform one-way latency range;
      the reference default is 1-10 ms.
    """

    packet_loss_rate: float = 0.0
    send_latency: tuple[float, float] = (0.001, 0.010)

    @classmethod
    def from_dict(cls, d: dict) -> "NetConfig":
        cfg = cls()
        if "packet_loss_rate" in d:
            cfg.packet_loss_rate = float(d["packet_loss_rate"])
        if "send_latency" in d:
            lo, hi = d["send_latency"]
            cfg.send_latency = (float(lo), float(hi))
        return cfg


@dataclass
class TcpConfig:
    """Placeholder, matching the reference's empty TcpConfig
    (sim/net/tcp/config.rs)."""

    @classmethod
    def from_dict(cls, d: dict) -> "TcpConfig":
        return cls()


@dataclass
class Config:
    net: NetConfig = field(default_factory=NetConfig)
    tcp: TcpConfig = field(default_factory=TcpConfig)

    def hash(self) -> int:
        """Stable content hash (reference config.rs:27-31).

        Uses sha256 over the canonical dataclass repr — independent of
        PYTHONHASHSEED so the printed repro recipe is portable.
        """
        canon = repr(dataclasses.asdict(self)).encode()
        return int.from_bytes(hashlib.sha256(canon).digest()[:8], "big")

    @classmethod
    def from_toml(cls, text: str) -> "Config":
        d = tomllib.loads(text)
        return cls(
            net=NetConfig.from_dict(d.get("net", {})),
            tcp=TcpConfig.from_dict(d.get("tcp", {})),
        )

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_toml(f.read())
