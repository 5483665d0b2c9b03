"""Shared ctypes scaffolding for the native transport endpoints.

All three native transports (epoll ``msep_``, shared-memory ``shmep_``,
io_uring ``urep_``) export the identical C ABI shape — bind / send /
blocking recv / msg accessors / two-phase shutdown+free — and their
Python wrappers were line-for-line copies. This module is that wrapper
once: :func:`make_transport` binds the symbols for a prefix and returns
the loader plus an endpoint class, so a fix to the close/teardown
contract or the recv-executor pattern lands in every transport at once.

Each transport's library is compiled with g++ from the repo's
``native/*.cpp`` into ``build/native/<hash>/`` at the root of the
checkout, keyed by a hash of the source and the flags; it is written
under a temporary name and renamed into place, so processes that build
at once each get a whole library. The sources are read, never edited,
and nothing is written under ``native/``.
"""

from __future__ import annotations

import asyncio
import ctypes
import hashlib
import os
import pickle
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE = os.path.join(_REPO, "native")
BUILD_ROOT = os.path.join(_REPO, "build", "native")
# native/Makefile's flags and link libraries for the transports
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
LINK = ("-lpthread", "-lrt")

__all__ = ["make_transport", "split_addr"]


def split_addr(addr) -> tuple[str, int]:
    if isinstance(addr, tuple):
        return addr[0], int(addr[1])
    host, port = str(addr).rsplit(":", 1)
    return host, int(port)


def make_transport(prefix: str, src_name: str, lib_name: str, label: str):
    """Return ``(build, load, EndpointClass)`` for one native transport.

    ``prefix`` is the C symbol prefix (``msep_``/``shmep_``/``urep_``),
    ``src_name`` the source under ``native/``, ``lib_name`` the library
    built from it under ``build/native/<hash>/``, ``label`` the human
    name used in error messages and thread names.
    """
    src_path = os.path.join(_NATIVE, src_name)
    state = {"lib": None}
    lock = threading.Lock()

    def build() -> str:
        with open(src_path, "rb") as f:
            h = hashlib.sha256(f.read())
        h.update(" ".join((*CXX_FLAGS, *LINK)).encode())
        lib_path = os.path.join(BUILD_ROOT, h.hexdigest()[:16], lib_name)
        if os.path.exists(lib_path):
            return lib_path
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
        done = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", tmp, src_path, *LINK],
            capture_output=True, text=True,
        )
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed building {src_name}:\n{done.stderr}")
        os.replace(tmp, lib_path)
        return lib_path

    def load() -> ctypes.CDLL:
        with lock:
            if state["lib"] is None:
                lib = ctypes.CDLL(build())
                g = lambda name: getattr(lib, prefix + name)  # noqa: E731
                g("bind").restype = ctypes.c_void_p
                g("bind").argtypes = [
                    ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
                ]
                g("send").restype = ctypes.c_int
                g("send").argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                    ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
                ]
                g("recv").restype = ctypes.c_void_p
                g("recv").argtypes = [
                    ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
                ]
                g("msg_len").restype = ctypes.c_uint64
                g("msg_len").argtypes = [ctypes.c_void_p]
                g("msg_data").restype = ctypes.POINTER(ctypes.c_uint8)
                g("msg_data").argtypes = [ctypes.c_void_p]
                g("msg_src_ip").restype = ctypes.c_char_p
                g("msg_src_ip").argtypes = [ctypes.c_void_p]
                g("msg_src_port").restype = ctypes.c_int
                g("msg_src_port").argtypes = [ctypes.c_void_p]
                g("msg_free").argtypes = [ctypes.c_void_p]
                g("shutdown").argtypes = [ctypes.c_void_p]
                g("free").argtypes = [ctypes.c_void_p]
                state["lib"] = lib
            return state["lib"]

    class Endpoint:
        """Tag-matching endpoint on a native transport, asyncio-friendly.

        Blocking native receives run on a thread-pool executor so the
        asyncio surface stays non-blocking; payloads are pickled here
        (the transports carry opaque bytes)."""

        def __init__(self, handle: int, port: int, host: str):
            self._h = handle
            self._host = host
            self._port = port
            self._pool = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix=f"{prefix}recv"
            )
            self._closed = False

        @classmethod
        async def bind(cls, addr) -> "Endpoint":
            host, port = split_addr(addr)
            lib = load()
            out_port = ctypes.c_int(0)
            h = getattr(lib, prefix + "bind")(
                host.encode(), port, ctypes.byref(out_port)
            )
            if not h:
                raise OSError(f"{label} endpoint bind failed for {host}:{port}")
            return cls(h, out_port.value, host)

        @property
        def local_addr(self) -> tuple[str, int]:
            return (self._host, self._port)

        async def send_to(self, dst, tag: int, payload: Any) -> None:
            if self._closed:
                raise ConnectionError("endpoint is closed")
            if tag >= (1 << 64) - 1 or tag < 0:
                raise ValueError("tag 2**64-1 is reserved for the handshake")
            ip, port = split_addr(dst)
            raw = pickle.dumps(payload)
            rc = getattr(load(), prefix + "send")(
                self._h, ip.encode(), port, tag, raw, len(raw)
            )
            if rc != 0:
                raise ConnectionError(f"{label} send to {ip}:{port} failed")

        async def recv_from(self, tag: int, timeout: Optional[float] = None):
            if self._closed:
                raise ConnectionError("endpoint is closed")
            loop = asyncio.get_event_loop()
            lib = load()
            timeout_ms = -1 if timeout is None else max(int(timeout * 1000), 0)
            recv = getattr(lib, prefix + "recv")

            def blocking():
                return recv(self._h, tag, timeout_ms)

            m = await loop.run_in_executor(self._pool, blocking)
            if not m:
                if self._closed:
                    raise ConnectionError("endpoint closed during receive")
                raise asyncio.TimeoutError(f"recv tag {tag} timed out")
            try:
                n = getattr(lib, prefix + "msg_len")(m)
                data = ctypes.string_at(getattr(lib, prefix + "msg_data")(m), n)
                src = (
                    getattr(lib, prefix + "msg_src_ip")(m).decode(),
                    getattr(lib, prefix + "msg_src_port")(m),
                )
            finally:
                getattr(lib, prefix + "msg_free")(m)
            return pickle.loads(data), src

        def close(self) -> None:
            if not self._closed:
                self._closed = True
                lib = load()
                # two-phase: wake every blocked receiver, drain the
                # pool, then free the native object (freeing earlier
                # would be a use-after-free under a blocked recv)
                getattr(lib, prefix + "shutdown")(self._h)
                self._pool.shutdown(wait=True)
                getattr(lib, prefix + "free")(self._h)

    Endpoint.__name__ = label.title().replace("_", "") + "Endpoint"
    return build, load, Endpoint
