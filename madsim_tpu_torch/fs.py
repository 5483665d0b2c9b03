"""Simulated per-node filesystem with power-failure semantics.

Parity with reference madsim/src/sim/fs.rs:
  * ``FsSim`` keeps an in-memory ``{path: INode}`` map per node
    (fs.rs:24-41); node reset = power failure.
  * ``File`` supports ``read_at`` / ``write_all_at`` / ``set_len`` /
    ``sync_all`` / ``metadata`` (fs.rs:148-229); free functions ``read``
    and ``metadata`` (fs.rs:232-248).
  * Power failure drops *unsynced* writes: each inode tracks its last
    ``sync_all`` snapshot and reset rolls back to it. (The reference
    leaves this as a TODO — fs.rs:51, fs.rs:204 — and currently keeps all
    data; we implement the intended semantics, which is strictly more
    useful for crash-consistency testing.)

Injectable disk faults (the asyncio twin of the batched engine's
``Workload.durable_sync`` discipline — ``chaos.Nemesis`` drives the same
``DiskFault`` plan windows through these hooks):

  * ``set_torn(node)`` — a power failure additionally re-applies a
    random *prefix* of the node's last unsynced write on top of the
    synced snapshot (the FoundationDB torn-write fault; the prefix
    length draws from the runtime's deterministic RNG).
  * ``set_sync_loss(node)`` — the node's disk lies: ``sync_all``
    silently commits nothing, so a later power failure still rolls the
    file back (the firmware-lies-about-fsync fault).
  * ``set_fail_writes(node)`` — writes raise ``OSError(EIO)``, the
    injectable write-error path.
"""

from __future__ import annotations

from typing import Optional

from .runtime import context
from .runtime.plugin import Simulator, node as current_node
from .runtime.runtime import DEFAULT_SIMULATORS

__all__ = ["FsSim", "File", "Metadata", "read", "write", "metadata"]


class Metadata:
    __slots__ = ("len",)

    def __init__(self, length: int):
        self.len = length

    def __repr__(self) -> str:
        return f"Metadata(len={self.len})"


class _INode:
    __slots__ = ("data", "synced", "last_write")

    def __init__(self) -> None:
        self.data = bytearray()
        self.synced = b""
        # (offset, payload) of the newest unsynced write — the write a
        # torn power failure tears; None once synced (or truncated:
        # set_len is a metadata op, not a tearable data write)
        self.last_write: Optional[tuple] = None

    def write(self, offset: int, data: bytes) -> None:
        buf = self.data
        end = offset + len(data)
        if len(buf) < end:
            buf.extend(b"\x00" * (end - len(buf)))
        buf[offset:end] = data
        self.last_write = (offset, bytes(data))

    def sync(self) -> None:
        self.synced = bytes(self.data)
        self.last_write = None

    def power_fail(self, torn: bool = False, rng=None) -> None:
        """Roll back to the synced snapshot; under ``torn`` a drawn
        prefix of the last unsynced write survives on top of it. The
        post-failure contents ARE the on-disk state — the snapshot is
        refreshed to them, so a second power failure cannot un-persist
        a torn fragment that physically reached the platter (the
        engine's rule: the torn prefix commits into ``SimState.disk``
        at the kill)."""
        last = self.last_write
        self.data = bytearray(self.synced)
        if torn and last is not None and rng is not None:
            offset, payload = last
            frag = payload[: rng.randrange(0, len(payload) + 1)]
            if frag:
                end = offset + len(frag)
                if len(self.data) < end:
                    self.data.extend(b"\x00" * (end - len(self.data)))
                self.data[offset:end] = frag
        self.synced = bytes(self.data)
        self.last_write = None


class FsSim(Simulator):
    """Filesystem device simulator (fs.rs:24-66)."""

    def __init__(self, rng, time, config, handle):
        super().__init__(rng, time, config, handle)
        self._nodes: dict[int, dict[str, _INode]] = {}
        self._torn: set[int] = set()
        self._sync_loss: set[int] = set()
        self._fail_writes: set[int] = set()

    def create_node(self, node_id: int) -> None:
        self._nodes.setdefault(node_id, {})

    def reset_node(self, node_id: int) -> None:
        """Power failure: every file rolls back to its last synced state
        (the intended semantics of fs.rs:51); an armed torn-write mode
        (``set_torn``) keeps a drawn prefix of each file's last unsynced
        write — the same fault the engine's KIND_TORN_ON injects."""
        torn = node_id in self._torn
        for inode in self._nodes.get(node_id, {}).values():
            inode.power_fail(torn=torn, rng=self.rng)

    # ---- injectable disk faults (chaos.DiskFault's asyncio twin) --------
    def set_torn(self, node_id: int, on: bool = True) -> None:
        """Arm/disarm torn-write mode: power failures tear the last
        unsynced write instead of dropping it cleanly."""
        (self._torn.add if on else self._torn.discard)(node_id)

    def set_sync_loss(self, node_id: int, on: bool = True) -> None:
        """Make/stop the node's disk lying: ``sync_all`` commits nothing
        while set, so power failures keep rolling back past it."""
        (self._sync_loss.add if on else self._sync_loss.discard)(node_id)

    def set_fail_writes(self, node_id: int, on: bool = True) -> None:
        """Inject write errors: ``write_all_at`` raises ``OSError(EIO)``."""
        (self._fail_writes.add if on else self._fail_writes.discard)(node_id)

    # ---- introspection (fs.rs:56-66) ------------------------------------
    def get_file_size(self, node_id: int, path: str) -> Optional[int]:
        inode = self._nodes.get(node_id, {}).get(str(path))
        return len(inode.data) if inode is not None else None

    def _dir(self, node_id: int) -> dict[str, _INode]:
        return self._nodes.setdefault(node_id, {})

    @staticmethod
    def current() -> "FsSim":
        return context.current_handle().simulator(FsSim)


class File:
    """An open file on the current node (fs.rs:148-229)."""

    def __init__(self, fs: FsSim, node: int, inode: _INode, path: str):
        self._fs = fs
        self._node = node
        self._inode = inode
        self.path = path

    @classmethod
    async def create(cls, path: str) -> "File":
        fs = FsSim.current()
        node = current_node()
        d = fs._dir(node)
        inode = _INode()
        d[str(path)] = inode
        return cls(fs, node, inode, str(path))

    @classmethod
    async def open(cls, path: str) -> "File":
        fs = FsSim.current()
        node = current_node()
        d = fs._dir(node)
        inode = d.get(str(path))
        if inode is None:
            raise FileNotFoundError(path)
        return cls(fs, node, inode, str(path))

    @classmethod
    async def open_or_create(cls, path: str) -> "File":
        fs = FsSim.current()
        node = current_node()
        d = fs._dir(node)
        inode = d.setdefault(str(path), _INode())
        return cls(fs, node, inode, str(path))

    async def read_at(self, n: int, offset: int) -> bytes:
        data = self._inode.data
        return bytes(data[offset : offset + n])

    async def write_all_at(self, data: bytes, offset: int) -> None:
        if self._node in self._fs._fail_writes:
            raise OSError(5, "simulated disk write error", self.path)
        self._inode.write(offset, bytes(data))

    async def set_len(self, n: int) -> None:
        if self._node in self._fs._fail_writes:
            raise OSError(5, "simulated disk write error", self.path)
        buf = self._inode.data
        if n < len(buf):
            del buf[n:]
        else:
            buf.extend(b"\x00" * (n - len(buf)))
        # truncation/extension is a metadata op: it is not the write a
        # torn power failure re-applies
        self._inode.last_write = None

    async def sync_all(self) -> None:
        """Persist: survives power failure from here (fs.rs:219) —
        unless the node's disk is inside an injected sync-loss window,
        in which case the call silently commits nothing (the lie is
        indistinguishable from a working fsync, exactly like the
        engine's KIND_SYNC_LOSS)."""
        if self._node in self._fs._sync_loss:
            return
        self._inode.sync()

    async def metadata(self) -> Metadata:
        return Metadata(len(self._inode.data))


async def read(path: str) -> bytes:
    """Whole-file read on the current node (fs.rs:232-239)."""
    f = await File.open(path)
    return await f.read_at(len(f._inode.data), 0)


async def write(path: str, data: bytes) -> None:
    f = await File.open_or_create(path)
    await f.set_len(0)
    await f.write_all_at(data, 0)


async def metadata(path: str) -> Metadata:
    f = await File.open(path)
    return await f.metadata()


if FsSim not in DEFAULT_SIMULATORS:
    # Registered before NetSim to match the reference's order
    # (runtime/mod.rs:62-63).
    DEFAULT_SIMULATORS.insert(0, FsSim)
