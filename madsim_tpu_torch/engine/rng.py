"""Counter-based RNG for the batched engine, on torch tensors.

Port of ``madsim_tpu/engine/rng.py``. Every draw is a pure function of
``(instance_seed, event_step, purpose)``:

  key     = (seed & 0xffffffff, seed >> 32)          # per-instance
  counter = (event_step, purpose)                     # per-draw
  value   = threefry2x32(key, counter)[0]             # 32 uniform bits

so draws are order-independent and reproducible from coordinates alone,
and the same coordinates give the same bits as the JAX engine and the
C++ oracle.

Torch has no unsigned 32-bit arithmetic, so a uint32 word travels as an
int64 tensor holding a value in ``[0, 2**32)``: every add is masked back
to 32 bits, and every right shift acts on a masked (non-negative) value,
where torch's arithmetic shift equals the logical one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "M32",
    "threefry2x32",
    "np_threefry2x32",
    "np_threefry2x32v",
    "Draw",
    "PurposeLane",
    "PURPOSE_LANES",
    "lane",
    "DRAW_SPAN_MAX",
    "PURPOSE_POLL_COST",
    "PURPOSE_CLOG_JITTER",
    "PURPOSE_TORN",
    "PURPOSE_RETRY",
    "PURPOSE_LATENCY",
    "PURPOSE_DUP",
    "PURPOSE_LOSS",
    "PURPOSE_USER",
    "PURPOSE_PLAN",
    "PURPOSE_EXPLORE",
    "PURPOSE_CLIENT",
    "PURPOSE_FARM",
    "chance_threshold",
]

M32 = 0xFFFFFFFF

# Threefry-2x32 rotation schedule (Random123 / Salmon et al. 2011).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
# Skein key-schedule parity constant for 32-bit words.
_PARITY = 0x1BD11BDA

# Every bounded draw reduces 32 uniform bits by ``bits % span``; a span
# wider than this would wrap.
DRAW_SPAN_MAX = (1 << 32) - 1


@dataclasses.dataclass(frozen=True)
class PurposeLane:
    """One declared block of the threefry purpose namespace."""

    name: str
    base: int
    width: int  # number of purpose values in the lane
    owner: str  # "engine" | "user" | "chaos" | "explore" | "farm"
    note: str = ""

    @property
    def end(self) -> int:
        """Exclusive upper bound of the lane."""
        return self.base + self.width


# The purpose registry, copied from the JAX package (tests hold the two
# equal). Engine lanes sit in [0, 128), user handler lanes above 128,
# host-side plan/explore/client/farm blocks at 0x9E37xxxx and up.
PURPOSE_LANES = (
    PurposeLane("poll_cost", 0, 1, "engine", "cost lane 0 / jitter lane 1"),
    PurposeLane("clog_jitter", 1, 1, "engine", "reserved/legacy"),
    PurposeLane("torn", 2, 1, "engine", "torn-write prefix draw"),
    PurposeLane("retry", 3, 1, "engine", "retry backoff jitter draw"),
    PurposeLane("latency", 8, 56, "engine", "base+slot, lat/loss pair"),
    PurposeLane("dup", 64, 64, "engine", "base+slot, dup shadow pair"),
    PurposeLane("user", 128, 0x9E370000 - 128, "user", "base+user purpose"),
    PurposeLane("plan", 0x9E370000, 1 << 16, "chaos", "base+plan slot"),
    PurposeLane("explore", 0x9E380000, 1 << 16, "explore", "base+batch slot"),
    PurposeLane("client", 0x9E390000, 1 << 16, "chaos", "base+plan slot"),
    PurposeLane("farm", 0x9E3A0000, 1 << 16, "farm", "base+slot, energy"),
)


def lane(name: str) -> PurposeLane:
    """The registered lane called ``name`` (KeyError if unknown)."""
    for ln in PURPOSE_LANES:
        if ln.name == name:
            return ln
    raise KeyError(f"no purpose lane named {name!r}")


PURPOSE_POLL_COST = lane("poll_cost").base
PURPOSE_CLOG_JITTER = lane("clog_jitter").base
PURPOSE_TORN = lane("torn").base
PURPOSE_RETRY = lane("retry").base
PURPOSE_LATENCY = lane("latency").base  # + emit slot, both lanes used
PURPOSE_DUP = lane("dup").base  # + shadow emit slot
PURPOSE_LOSS = PURPOSE_DUP  # legacy alias: the retired per-slot loss range
PURPOSE_USER = lane("user").base  # + user purpose
PURPOSE_PLAN = lane("plan").base
PURPOSE_EXPLORE = lane("explore").base
PURPOSE_CLIENT = lane("client").base
PURPOSE_FARM = lane("farm").base


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    # x holds a value in [0, 2**32): >> is logical there
    return ((x << r) | (x >> (32 - r))) & M32


def _word(x, device) -> torch.Tensor:
    """``x`` as int64 on ``device`` (None: where it is, the CPU for a host
    value). A Python or numpy integer becomes a filled scalar on the
    device, not a copy from host memory, which would wait for the
    device's queued work."""
    if isinstance(x, (int, np.integer)):
        return torch.full((), int(x), dtype=torch.int64, device=device)
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, over broadcastable int64 tensors.

    Inputs are uint32 words carried in int64 (values in ``[0, 2**32)``);
    so are the two outputs.
    """
    k0 = _word(k0, None)
    k1, x0, x1 = (_word(x, k0.device) for x in (k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for chunk in range(5):
        rots = _ROTATIONS[:4] if chunk % 2 == 0 else _ROTATIONS[4:]
        for r in rots:
            x0 = (x0 + x1) & M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(chunk + 1) % 3]) & M32
        x1 = (x1 + ks[(chunk + 2) % 3] + (chunk + 1)) & M32
    return x0, x1


def np_threefry2x32(k0, k1, x0, x1):
    """:func:`threefry2x32` on four numpy uint32 scalars: the host
    generator of the explore mutators' scalar draws
    (``explore.mutate.HostStream``)."""
    k0 = np.uint32(k0)
    k1 = np.uint32(k1)
    x0 = np.uint32(x0)
    x1 = np.uint32(x1)
    with np.errstate(over="ignore"):
        ks = (k0, k1, np.uint32(k0 ^ k1 ^ _PARITY))
        x0 = np.uint32(x0 + ks[0])
        x1 = np.uint32(x1 + ks[1])
        for chunk in range(5):
            rots = _ROTATIONS[:4] if chunk % 2 == 0 else _ROTATIONS[4:]
            for r in rots:
                x0 = np.uint32(x0 + x1)
                x1 = np.uint32((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r)))
                x1 = np.uint32(x1 ^ x0)
            x0 = np.uint32(x0 + ks[(chunk + 1) % 3])
            x1 = np.uint32(x1 + ks[(chunk + 2) % 3] + np.uint32(chunk + 1))
    return x0, x1


def np_threefry2x32v(k0, k1, x0, x1):
    """:func:`threefry2x32` over numpy uint32 arrays, on the host: the
    generator of the fault-plan compiler (``chaos/plan.py``), kept in
    numpy so that uint64 seeds never meet torch's unsigned gaps."""
    k0 = np.asarray(k0, np.uint32)
    k1 = np.asarray(k1, np.uint32)
    x0 = np.asarray(x0, np.uint32)
    x1 = np.asarray(x1, np.uint32)
    with np.errstate(over="ignore"):
        ks = (k0, k1, (k0 ^ k1 ^ _PARITY).astype(np.uint32))
        x0 = (x0 + ks[0]).astype(np.uint32)
        x1 = (x1 + ks[1]).astype(np.uint32)
        for chunk in range(5):
            rots = _ROTATIONS[:4] if chunk % 2 == 0 else _ROTATIONS[4:]
            for r in rots:
                x0 = (x0 + x1).astype(np.uint32)
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))).astype(np.uint32)
                x1 = (x1 ^ x0).astype(np.uint32)
            x0 = (x0 + ks[(chunk + 1) % 3]).astype(np.uint32)
            x1 = (x1 + ks[(chunk + 2) % 3] + np.uint32(chunk + 1)).astype(np.uint32)
    return x0, x1


class Draw:
    """Per-event draw context over a batch of seeds.

    ``k0``/``k1``/``step`` are ``(S,)`` int64 tensors holding uint32
    words. ``cache`` maps a static purpose to the ``(lane0, lane1)``
    pair the step already generated in its batched block — the same
    ``(seed, step, purpose)`` counter, so the same value.
    """

    __slots__ = ("k0", "k1", "step", "cache")

    def __init__(self, seed: torch.Tensor, step: torch.Tensor, cache=None):
        # seed carries a uint64 bit pattern in int64: mask after the
        # arithmetic shift to get the logical high word
        self.k0 = seed & M32
        self.k1 = (seed >> 32) & M32
        self.step = step & M32
        self.cache = cache

    def bits(self, purpose: int) -> torch.Tensor:
        """32 uniform bits for ``purpose``, ``(S,)``."""
        return self.bits2(purpose)[0]

    def bits2(self, purpose: int):
        """Both 32-bit lanes of one threefry block."""
        if self.cache is not None and int(purpose) in self.cache:
            return self.cache[int(purpose)]
        return threefry2x32(self.k0, self.k1, self.step, int(purpose) & M32)

    def block2(self, purposes):
        """Both lanes of many purposes in one batched cipher pass:
        ``(S, L)`` tensors for the ``L`` static purposes."""
        p = torch.tensor(
            [int(x) & M32 for x in purposes], dtype=torch.int64,
            device=self.k0.device,
        )
        return threefry2x32(
            self.k0[:, None], self.k1[:, None], self.step[:, None], p[None, :]
        )

    @staticmethod
    def _reduce(bits, lo, hi):
        """``lo + bits % max(uint32(hi - lo), 1)`` as int64."""
        span = torch.as_tensor(hi - lo, dtype=torch.int64) & M32
        span = torch.clamp(span, min=1).to(bits.device)
        return lo + bits % span

    def uniform_int(self, lo, hi, purpose: int) -> torch.Tensor:
        """Uniform int64 in [lo, hi) by modulo reduction."""
        return self._reduce(self.bits(purpose), lo, hi)

    def chance(self, threshold_u32: int, purpose: int) -> torch.Tensor:
        """True with probability threshold/2^32 (2^32 = always)."""
        return self.bits(purpose) < int(threshold_u32)

    def user(self, purpose: int) -> torch.Tensor:
        """32 bits in the user purpose namespace."""
        return self.bits(PURPOSE_USER + int(purpose))

    def user_int(self, lo, hi, purpose: int) -> torch.Tensor:
        """Uniform int64 in [lo, hi) in the user purpose namespace."""
        return self.uniform_int(lo, hi, PURPOSE_USER + int(purpose))


def chance_threshold(p: float) -> int:
    """Probability -> threshold for :meth:`Draw.chance`, in [0, 2^32];
    2^32 means always true."""
    if p <= 0.0:
        return 0
    if p >= 1.0:
        return 1 << 32
    return int(p * (1 << 32))
