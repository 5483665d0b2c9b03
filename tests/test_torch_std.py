"""The port's real backend (``std``): the TCP tag-matching ``Endpoint``
and its RPC, the OS filesystem, wall-clock time, and the native
transports (epoll, shared memory, io_uring), after the JAX package's
``test_std_backend.py``, ``test_native_transport.py``,
``test_shm_transport.py`` and ``test_uring_transport.py``.

Real I/O is not deterministic, so these hold behaviour, never which
transport is faster: every endpoint binds port 0 on loopback. A port
endpoint and a JAX package endpoint exchange messages on the one wire
format, both ways. The port builds its native libraries with g++ into
``build/native/<hash>/``, never into ``native/lib/``.
"""

import _torch_threads  # noqa: F401
import asyncio
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from madsim_tpu.std import net as j_net
from madsim_tpu_torch.std import _ctypes_ep
from madsim_tpu_torch.std import fastpath
from madsim_tpu_torch.std import fs as std_fs
from madsim_tpu_torch.std import native as native_mod
from madsim_tpu_torch.std import net as std_net
from madsim_tpu_torch.std import time as std_time
from madsim_tpu_torch.std import uring as uring_mod

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")


@pytest.fixture
def uring(gxx):
    if not uring_mod.available():
        pytest.skip("io_uring unavailable")


def run(coro):
    return asyncio.run(coro)


class Echo:
    """Request types live at module scope: RPC ids name the type's module
    and name, and pickle needs nameable types."""

    def __init__(self, text):
        self.text = text


class Boom:
    pass


class Nobody:
    pass


class Put:
    def __init__(self, key):
        self.key = key


# ---------------------------------------------------------------- std
def test_endpoint_tag_matching_over_loopback():
    async def main():
        a = await std_net.Endpoint.bind("127.0.0.1:0")
        b = await std_net.Endpoint.bind("127.0.0.1:0")
        await a.send_to(b.local_addr, 7, {"hi": 1})
        payload, src = await b.recv_from(7)
        await b.send_to(src, 9, "pong")
        payload2, _ = await a.recv_from(9)
        await a.send_to(b.local_addr, 8, "eight")
        await a.send_to(b.local_addr, 7, "seven")
        p7, _ = await b.recv_from(7)
        p8, _ = await b.recv_from(8)
        await a.close()
        await b.close()
        return payload, payload2, p7, p8

    assert run(main()) == ({"hi": 1}, "pong", "seven", "eight")


def test_rpc_roundtrip_errors_and_data():
    async def main():
        server = await std_net.Endpoint.bind("127.0.0.1:0")
        client = await std_net.Endpoint.bind("127.0.0.1:0")
        stored = {}

        async def echo(req):
            return req.text.upper()

        async def boom(req):
            raise ValueError("kapow")

        async def put(req, data):
            stored[req.key] = data
            return len(data), b"ack"

        server.add_rpc_handler(Echo, echo)
        server.add_rpc_handler(Boom, boom)
        server.add_rpc_handler_with_data(Put, put)
        out = [await client.call(server.local_addr, Echo("hello"))]
        with pytest.raises(ValueError, match="kapow"):
            await client.call(server.local_addr, Boom())
        with pytest.raises(asyncio.TimeoutError):
            await client.call(server.local_addr, Nobody(), timeout=0.2)
        out.append(await client.call_with_data(server.local_addr, Put("k"), b"\x00" * 4096))
        await server.close()
        await client.close()
        return out, stored

    out, stored = run(main())
    assert out == ["HELLO", (4096, b"ack")] and stored == {"k": b"\x00" * 4096}


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_std_endpoint_interoperates_with_the_jax_package(direction):
    """A port endpoint and a JAX package endpoint on loopback: tagged
    messages both ways, and an RPC served by one and called by the
    other."""
    first, second = (std_net, j_net) if direction == "port-to-jax" else (j_net, std_net)

    async def main():
        a = await first.Endpoint.bind("127.0.0.1:0")
        b = await second.Endpoint.bind("127.0.0.1:0")

        async def echo(req):
            return req.text[::-1]

        b.add_rpc_handler(Echo, echo)
        await a.send_to(b.local_addr, 3, [1, "two", 3.0])
        payload, src = await b.recv_from(3)
        await b.send_to(src, 4, {"ok": True})
        back, src2 = await a.recv_from(4)
        rpc = await a.call(b.local_addr, Echo("abc"), timeout=10)
        await a.close()
        await b.close()
        return payload, back, src[1] == a.local_addr[1], src2[1] == b.local_addr[1], rpc

    assert run(main()) == ([1, "two", 3.0], {"ok": True}, True, True, "cba")


def test_std_fs_roundtrip(tmp_path):
    async def main():
        p = tmp_path / "blob"
        f = await std_fs.File.create(p)
        await f.write_all_at(b"hello world", 0)
        await f.sync_all()
        part = await f.read_at(5, 6)
        meta = await f.metadata()
        await f.set_len(5)
        out = [part, meta.len, (await std_fs.metadata(p)).len, await std_fs.read(p)]
        f.close()
        return out

    assert run(main()) == [b"world", 11, 5, b"hello"]


def test_std_time():
    async def main():
        t0 = std_time.now()
        await std_time.sleep(0.05)
        waited = std_time.now() - t0
        with pytest.raises(std_time.Elapsed):
            await std_time.timeout(0.05, asyncio.sleep(5))
        return waited

    assert run(main()) >= 0.04


# ------------------------------------------------------------ native
def test_native_libraries_build_into_their_own_directory(gxx):
    """Each transport's library lies under ``build/native/<hash>/``,
    keyed by its source and flags, and nowhere under ``native/``."""
    paths = [Path(m.build()) for m in (native_mod, fastpath)]
    for p in paths:
        assert p.exists() and p.parent.parent == ROOT / "build" / "native"
        assert ROOT / "native" not in p.parents
    assert paths[0].parent != paths[1].parent
    assert [p.name for p in paths] == ["libmstransport.so", "libshmtransport.so"]
    assert Path(_ctypes_ep.BUILD_ROOT) == ROOT / "build" / "native"


def test_concurrent_builds_each_get_a_whole_library(gxx, tmp_path):
    """Processes that build at once write under their own temporary
    names and rename into place: every one loads the library."""
    root = tmp_path / "native-build"
    code = (
        "import sys\n"
        "from madsim_tpu_torch.std import _ctypes_ep\n"
        f"_ctypes_ep.BUILD_ROOT = {str(root)!r}\n"
        "build, load, _ep = _ctypes_ep.make_transport('msep_', 'transport.cpp', "
        "'libmstransport.so', 'native')\n"
        "print(build(), bool(load().msep_bind))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len({o[0] for o in outs}) == 1 and all(o[1] == "True" for o in outs)
    assert [p.name for p in Path(outs[0][0]).parent.iterdir()] == ["libmstransport.so"]


def test_native_roundtrip_timeout_and_order(gxx):
    async def main():
        a = await native_mod.NativeEndpoint.bind("127.0.0.1:0")
        b = await native_mod.NativeEndpoint.bind("127.0.0.1:0")
        try:
            await a.send_to(("127.0.0.1", b.local_addr[1]), 5, {"x": [1, 2, 3]})
            payload, src = await b.recv_from(5, timeout=5)
            await b.send_to(src, 6, "pong")
            payload2, _ = await a.recv_from(6, timeout=5)
            with pytest.raises(asyncio.TimeoutError):
                await a.recv_from(1, timeout=0.2)
            for i in range(100):
                await a.send_to(("127.0.0.1", b.local_addr[1]), 1, i)
            got = [(await b.recv_from(1, timeout=5))[0] for _ in range(100)]
            return payload, payload2, got
        finally:
            a.close()
            b.close()

    assert run(main()) == ({"x": [1, 2, 3]}, "pong", list(range(100)))


@pytest.mark.parametrize("peer", ["port", "jax"])
def test_native_interops_with_the_asyncio_backend(gxx, peer):
    """The port's epoll endpoint and an asyncio endpoint, the port's or
    the JAX package's, exchange messages on the shared wire format."""
    net = std_net if peer == "port" else j_net

    async def main():
        py = await net.Endpoint.bind("127.0.0.1:0")
        cc = await native_mod.NativeEndpoint.bind("127.0.0.1:0")
        try:
            await cc.send_to(("127.0.0.1", py.local_addr[1]), 9, [1, "two", 3.0])
            payload, src = await py.recv_from(9)
            await py.send_to(src, 10, {"ok": True})
            payload2, src2 = await cc.recv_from(10, timeout=5)
            return (payload, src[1] == cc.local_addr[1], payload2,
                    src2[1] == py.local_addr[1])
        finally:
            cc.close()
            await py.close()

    assert run(main()) == ([1, "two", 3.0], True, {"ok": True}, True)


# --------------------------------------------------------------- shm
def test_shm_roundtrip_refused_and_large_payload(gxx):
    async def main():
        a = await fastpath.ShmEndpoint.bind("127.0.0.1:0")
        b = await fastpath.ShmEndpoint.bind("127.0.0.1:0")
        blob = bytes(range(256)) * 4096  # 1 MiB
        try:
            await a.send_to(("127.0.0.1", b.local_addr[1]), 5, {"x": [1, 2, 3]})
            payload, src = await b.recv_from(5, timeout=5)
            await b.send_to(src, 6, "pong")
            payload2, _ = await a.recv_from(6, timeout=5)
            with pytest.raises(asyncio.TimeoutError):
                await a.recv_from(1, timeout=0.2)
            with pytest.raises(ConnectionError):
                await a.send_to(("127.0.0.1", 1), 1, "nobody home")
            for i in range(200):
                await a.send_to(("127.0.0.1", b.local_addr[1]), 1, i)
            got = [(await b.recv_from(1, timeout=5))[0] for _ in range(200)]
            await a.send_to(("127.0.0.1", b.local_addr[1]), 2, blob)
            big, _ = await b.recv_from(2, timeout=10)
            return payload, payload2, got, big == blob
        finally:
            a.close()
            b.close()

    assert run(main()) == ({"x": [1, 2, 3]}, "pong", list(range(200)), True)


def test_shm_backpressure_does_not_deadlock(gxx):
    async def main():
        a = await fastpath.ShmEndpoint.bind("127.0.0.1:0")
        b = await fastpath.ShmEndpoint.bind("127.0.0.1:0")
        blob, n = b"z" * 65536, 100
        try:
            async def flood(src, dst):
                for _ in range(n):
                    await src.send_to(("127.0.0.1", dst.local_addr[1]), 3, blob)

            async def drain(ep):
                for _ in range(n):
                    await ep.recv_from(3, timeout=30)

            await asyncio.wait_for(
                asyncio.gather(flood(a, b), flood(b, a), drain(a), drain(b)), timeout=60)
            return True
        finally:
            a.close()
            b.close()

    assert run(main())


def test_pick_endpoint_prefers_shm_on_loopback(gxx):
    async def main():
        ep = await fastpath.pick_endpoint("127.0.0.1:0")
        try:
            return type(ep).__name__
        finally:
            ep.close()

    assert run(main()) == "ShmEndpoint"


# ------------------------------------------------------------- uring
def test_uring_roundtrip_payload_order_and_timeout(uring):
    async def main():
        a = await uring_mod.UringEndpoint.bind("127.0.0.1:0")
        b = await uring_mod.UringEndpoint.bind("127.0.0.1:0")
        blob = bytes(range(256)) * 4096
        try:
            await a.send_to(("127.0.0.1", b.local_addr[1]), 5, {"x": [1, 2, 3]})
            payload, src = await b.recv_from(5, timeout=5)
            await b.send_to(src, 6, "pong")
            payload2, _ = await a.recv_from(6, timeout=5)
            for i in range(5):
                await a.send_to(b.local_addr, 9, (i, blob))
            order = []
            for _ in range(5):
                (n, got), _ = await b.recv_from(9, timeout=10)
                order.append((n, got == blob))
            with pytest.raises(asyncio.TimeoutError):
                await a.recv_from(1, timeout=0.2)
            return payload, payload2, order
        finally:
            a.close()
            b.close()

    assert run(main()) == ({"x": [1, 2, 3]}, "pong", [(i, True) for i in range(5)])


@pytest.mark.parametrize("peer", ["epoll", "asyncio-port", "asyncio-jax"])
def test_uring_interops(uring, peer):
    async def bind():
        if peer == "epoll":
            return await native_mod.NativeEndpoint.bind("127.0.0.1:0")
        net = std_net if peer == "asyncio-port" else j_net
        return await net.Endpoint.bind("127.0.0.1:0")

    async def main():
        u = await uring_mod.UringEndpoint.bind("127.0.0.1:0")
        e = await bind()
        try:
            await u.send_to(e.local_addr, 21, ["uring", "to", peer])
            if peer == "epoll":
                payload, src = await e.recv_from(21, timeout=5)
            else:
                payload, src = await e.recv_from(21)
            await e.send_to(src, 22, {"back": True})
            payload2, _ = await u.recv_from(22, timeout=5)
            return payload, payload2
        finally:
            u.close()
            if peer == "epoll":
                e.close()
            else:
                await e.close()

    assert run(main()) == (["uring", "to", peer], {"back": True})


def test_pick_endpoint_selects_uring_then_epoll(uring):
    async def main():
        ep = await fastpath.pick_endpoint("127.0.0.1:0", prefer_shm=False)
        ep2 = await fastpath.pick_endpoint("127.0.0.1:0", prefer_shm=False,
                                           prefer_uring=False)
        kinds = type(ep).__name__, type(ep2).__name__
        ep.close()
        ep2.close()
        return kinds

    assert run(main()) == ("UringEndpoint", "NativeEndpoint")
