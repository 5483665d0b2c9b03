"""Real-filesystem backend with the simulated fs API surface.

Parity with reference madsim/src/std/fs.rs (C29): the same ``File`` /
``read`` / ``metadata`` names as madsim_tpu_torch.fs, over the real OS
filesystem, so application code moves between sim and production
unchanged.
"""

from __future__ import annotations

import os
from typing import Union

__all__ = ["File", "read", "metadata", "Metadata"]

PathLike = Union[str, os.PathLike]


class Metadata:
    __slots__ = ("len",)

    def __init__(self, length: int):
        self.len = length


class File:
    def __init__(self, fh, path: str):
        self._fh = fh
        self.path = path

    @classmethod
    async def create(cls, path: PathLike) -> "File":
        return cls(open(path, "w+b"), str(path))

    @classmethod
    async def open(cls, path: PathLike) -> "File":
        return cls(open(path, "r+b"), str(path))

    async def read_at(self, buf_len: int, offset: int) -> bytes:
        self._fh.seek(offset)
        return self._fh.read(buf_len)

    async def write_all_at(self, data: bytes, offset: int) -> None:
        self._fh.seek(offset)
        self._fh.write(data)

    async def set_len(self, size: int) -> None:
        self._fh.truncate(size)

    async def sync_all(self) -> None:
        self._fh.flush()
        os.fsync(self._fh.fileno())

    async def metadata(self) -> Metadata:
        return Metadata(os.fstat(self._fh.fileno()).st_size)

    def close(self) -> None:
        self._fh.close()


async def read(path: PathLike) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


async def metadata(path: PathLike) -> Metadata:
    return Metadata(os.stat(path).st_size)
