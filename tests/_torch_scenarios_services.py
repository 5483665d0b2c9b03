"""Scenario programs that hold the port's last single-seed layers
(``sync``, ``compat.asyncio``, ``services``) against the JAX package's.

A scenario is ``f(ms, seed) -> log``, as in ``_torch_scenarios.py``: one
async program written once against a package object ``ms``
(``madsim_tpu`` or ``madsim_tpu_torch``), run on a fresh
``Runtime(seed=seed)``; its log holds what the program saw (virtual
times, values received, results, the type and message of each
exception). The tests assert that both packages give equal logs, and
that the port's run ends with a result, not an exception.

The scenarios follow the JAX package's own tests of these layers
(``test_sync.py``, ``test_compat_asyncio.py``, ``test_services.py``,
``test_grpc_codegen.py``), and keep their assertions: a scenario whose
program breaks one logs the ``AssertionError``.
"""

from __future__ import annotations

from pathlib import Path

from _torch_scenarios import attempt, mod, norm, run, scenario

SYNC: dict = {}
COMPAT: dict = {}
SERVICES: dict = {}

PROTO = Path(__file__).resolve().parent.parent / "examples" / "proto" / "helloworld.proto"


# ---------------------------------------------------------------- sync
@scenario(SYNC)
def oneshot(ms, seed):
    sync = mod(ms, "sync")

    async def main():
        tx, rx = sync.oneshot()

        async def producer():
            await ms.sleep(1.0)
            tx.send(99)

        ms.spawn(producer())
        got = await rx.recv()
        return [got, ms.now_ns()]

    return run(ms, seed, main)


@scenario(SYNC)
def mpsc_bounded_backpressure(ms, seed):
    sync = mod(ms, "sync")

    async def main():
        tx, rx = sync.channel(capacity=2)
        sent = []

        async def producer():
            for i in range(5):
                await tx.send(i)
                sent.append((i, ms.now_ns()))

        ms.spawn(producer())
        await ms.sleep(1.0)
        before = list(sent)
        assert len(before) <= 3
        got = [await rx.recv() for _ in range(5)]
        assert got == list(range(5))
        return [before, got, sent]

    return run(ms, seed, main)


@scenario(SYNC)
def mpsc_close_and_errors(ms, seed):
    sync = mod(ms, "sync")

    async def main():
        tx, rx = sync.unbounded_channel()
        await tx.send("a")
        tx.close()
        out = [await rx.recv(), await rx.recv()]
        out.append(await attempt(tx.send("b")))
        # a oneshot whose receiver closed refuses the send, and one whose
        # sender is gone ends its receiver
        tx2, rx2 = sync.oneshot()
        rx2.close()
        try:
            tx2.send(1)
        except sync.ChannelClosed as e:
            out.append(norm(e))
        out.append(tx2.is_closed())
        tx3, rx3 = sync.oneshot()
        rx3.close()
        out.append(await attempt(rx3.recv()))
        return out

    return run(ms, seed, main)


@scenario(SYNC)
def watch_changes(ms, seed):
    sync = mod(ms, "sync")

    async def main():
        tx, rx = sync.watch("v0")
        seen = []

        async def watcher():
            while True:
                await rx.changed()
                seen.append((rx.borrow(), ms.now_ns()))
                if rx.borrow() == "v2":
                    return

        jh = ms.spawn(watcher())
        await ms.sleep(0.1)
        tx.send("v1")
        await ms.sleep(0.1)
        tx.send("v2")
        await jh
        return seen

    return run(ms, seed, main)


@scenario(SYNC)
def mutex_exclusion(ms, seed):
    sync = mod(ms, "sync")

    async def main():
        m = sync.Mutex(0)
        trace = []

        async def worker(tag):
            async with m:
                trace.append((tag, "in", ms.now_ns()))
                await ms.sleep(1.0)
                trace.append((tag, "out", ms.now_ns()))

        for t in range(3):
            ms.spawn(worker(t))
        await ms.sleep(10.0)
        for i in range(0, len(trace), 2):
            assert trace[i][0] == trace[i + 1][0]
            assert trace[i][1] == "in" and trace[i + 1][1] == "out"
        return trace

    return run(ms, seed, main)


@scenario(SYNC)
def rwlock_readers_then_writer(ms, seed):
    sync = mod(ms, "sync")

    async def main():
        lock = sync.RwLock(0)
        events = []

        async def reader(tag):
            async with await lock.read() as v:
                events.append(("r", tag, v, ms.now_ns()))
                await ms.sleep(1.0)

        async def writer():
            async with await lock.write() as g:
                g.value = 42
                events.append(("w", None, g.value, ms.now_ns()))
                await ms.sleep(1.0)

        ms.spawn(reader(1))
        ms.spawn(reader(2))
        await ms.sleep(0.1)
        ms.spawn(writer())
        await ms.sleep(5.0)
        async with await lock.read() as v:
            final = v
        assert final == 42 and [e[0] for e in events] == ["r", "r", "w"]
        return [events, final]

    return run(ms, seed, main)


@scenario(SYNC)
def rwlock_writer_not_starved(ms, seed):
    sync = mod(ms, "sync")

    async def main():
        lock = sync.RwLock(0)
        wrote = ms.SimFuture()

        async def reader_loop(phase):
            await ms.sleep(phase)
            for _ in range(20):
                async with await lock.read():
                    await ms.sleep(1.0)

        async def writer():
            await ms.sleep(1.2)
            async with await lock.write() as g:
                g.value = 1
                wrote.set_result(ms.now_ns())

        ms.spawn(reader_loop(0.0))
        ms.spawn(reader_loop(0.5))
        ms.spawn(writer())
        t = await wrote
        assert t < 5e9
        return t

    return run(ms, seed, main)


@scenario(SYNC)
def semaphore_limits_and_wakeups(ms, seed):
    sync = mod(ms, "sync")

    async def main():
        sem = sync.Semaphore(2)
        active = {"n": 0, "max": 0}
        order = []

        async def worker(i):
            async with sem:
                active["n"] += 1
                active["max"] = max(active["max"], active["n"])
                order.append((i, ms.now_ns()))
                await ms.sleep(1.0)
                active["n"] -= 1

        for i in range(6):
            ms.spawn(worker(i))
        await ms.sleep(10.0)
        assert active["max"] == 2
        # release wakes every waiter: a small one is not stranded behind
        # a large one
        sem2 = sync.Semaphore(0)
        done = []

        async def big():
            await sem2.acquire(2)
            done.append(("big", ms.now_ns()))

        async def small():
            await sem2.acquire(1)
            done.append(("small", ms.now_ns()))

        ms.spawn(big())
        await ms.sleep(0.1)
        ms.spawn(small())
        await ms.sleep(0.1)
        sem2.release(1)
        await ms.sleep(1.0)
        first = list(done)
        assert [d[0] for d in first] == ["small"]
        sem2.release(2)
        await ms.sleep(1.0)
        return [order, active["max"], done]

    return run(ms, seed, main)


@scenario(SYNC)
def notify_barrier_broadcast(ms, seed):
    sync = mod(ms, "sync")

    async def main():
        n = sync.Notify()
        woke = []

        async def waiter(tag):
            await n.notified()
            woke.append((tag, ms.now_ns()))

        for t in range(3):
            ms.spawn(waiter(t))
        await ms.sleep(0.1)
        n.notify_one()
        await ms.sleep(0.1)
        one = len(woke)
        n.notify_waiters()
        await ms.sleep(0.1)
        b = sync.Barrier(3)
        leaders = []

        async def worker(delay):
            await ms.sleep(delay)
            leaders.append((await b.wait(), ms.now_ns()))

        for d in (0.1, 0.5, 1.0):
            ms.spawn(worker(d))
        await ms.sleep(2.0)
        assert one == 1 and len(woke) == 3
        assert sorted(x[0] for x in leaders) == [False, False, True]
        tx = sync.broadcast()
        r1, r2 = tx.subscribe(), tx.subscribe()
        sent = tx.send("x")
        return [woke, leaders, sent, await r1.recv(), await r2.recv()]

    return run(ms, seed, main)


# -------------------------------------------------------------- compat
@scenario(COMPAT)
def sleep_and_gather(ms, seed):
    aio = mod(ms, "compat.asyncio")

    async def main():
        t0 = ms.now_ns()
        await aio.sleep(5.0)
        waited = ms.now_ns() - t0

        async def work(i):
            await aio.sleep(0.01 * i)
            return i * 10

        t = aio.create_task(work(1))
        pending = t.done()
        results = await aio.gather(work(2), work(3))
        assert waited >= 5e9 and results == [20, 30] and not pending
        return [waited, pending, results, await t, ms.now_ns()]

    return run(ms, seed, main)


@scenario(COMPAT)
def wait_for_wait_and_timeout(ms, seed):
    aio = mod(ms, "compat.asyncio")

    async def main():
        out = [await attempt(aio.wait_for(aio.sleep(10), timeout=0.5)), ms.now_ns()]
        out.append(await aio.wait_for(aio.sleep(0.1, "done"), timeout=5))

        async def fast():
            await aio.sleep(0.1)
            return "fast"

        async def slow():
            await aio.sleep(9.0)
            return "slow"

        done, pending = await aio.wait([fast(), slow()], return_when=aio.FIRST_COMPLETED)
        out.append([len(done), len(pending), next(iter(done)).result()])
        for p in pending:
            p.cancel()
        hung = ms.SimFuture(name="never")
        t0 = ms.now_ns()

        async def guarded():
            async with aio.timeout(2.0):
                await hung

        out.append(await attempt(guarded()))
        out.append(ms.now_ns() - t0)
        async with aio.timeout(5.0):
            await aio.sleep(0.1)
        await aio.sleep(10.0)
        out.append(ms.now_ns())
        return out

    return run(ms, seed, main)


@scenario(COMPAT)
def queues(ms, seed):
    aio = mod(ms, "compat.asyncio")

    async def main():
        q = aio.Queue(maxsize=2)
        got = []

        async def producer():
            for i in range(6):
                await q.put(i)

        async def consumer():
            for _ in range(6):
                got.append((await q.get(), ms.now_ns()))

        p = aio.create_task(producer())
        c = aio.create_task(consumer())
        await p
        await c
        q2 = aio.Queue(maxsize=1)
        q2.put_nowait(1)
        full = None
        try:
            q2.put_nowait(2)
        except aio.QueueFull as e:
            full = norm(e)
        pq = aio.PriorityQueue()
        for x in (3, 1, 2):
            pq.put_nowait(x)
        lq = aio.LifoQueue()
        for x in (1, 2, 3):
            lq.put_nowait(x)
        # join blocks on the unfinished count, not emptiness
        jq = aio.Queue()
        done = []

        async def worker():
            while True:
                item = await jq.get()
                await aio.sleep(0.01)
                done.append((item, ms.now_ns()))
                jq.task_done()

        for i in range(8):
            await jq.put(i)
        workers = [aio.create_task(worker()) for _ in range(3)]
        await jq.join()
        for w in workers:
            w.cancel()
        extra = None
        try:
            jq.task_done()
        except ValueError as e:
            extra = norm(e)
        assert [g for g, _t in got] == list(range(6))
        assert sorted(d for d, _t in done) == list(range(8))
        return [got, full, [pq.get_nowait() for _ in range(3)],
                [lq.get_nowait() for _ in range(3)], done, extra]

    return run(ms, seed, main)


@scenario(COMPAT)
def lock_event_semaphore(ms, seed):
    aio = mod(ms, "compat.asyncio")

    async def main():
        lock = aio.Lock()
        order = []

        async def worker(i):
            async with lock:
                order.append(("enter", i, ms.now_ns()))
                await aio.sleep(0.1)
                order.append(("exit", i, ms.now_ns()))

        await aio.gather(worker(1), worker(2))
        ev = aio.Event()
        seen = []

        async def waiter():
            await ev.wait()
            seen.append(ms.now_ns())

        t = aio.create_task(waiter())
        await aio.sleep(0.05)
        before = list(seen)
        ev.set()
        await t
        sem = aio.BoundedSemaphore(1)
        async with sem:
            locked = sem.locked()
        over = None
        try:
            sem.release()
        except ValueError as e:
            over = norm(e)
        cond = aio.Condition()
        woken = []

        async def cwait(i):
            async with cond:
                await cond.wait()
                woken.append((i, ms.now_ns()))

        for i in range(3):
            aio.create_task(cwait(i))
        await aio.sleep(0.1)
        async with cond:
            cond.notify(2)
        await aio.sleep(0.1)
        async with cond:
            cond.notify_all()
        await aio.sleep(0.1)
        assert order[1][:2] == ("exit", order[0][1]) and before == [] and locked
        return [order, seen, locked, over, woken]

    return run(ms, seed, main)


@scenario(COMPAT)
def seeded_schedule(ms, seed):
    aio = mod(ms, "compat.asyncio")

    async def main():
        q = aio.Queue()

        async def noisy(i):
            await aio.sleep(ms.random() * 0.1)
            await q.put(i)

        for i in range(5):
            aio.create_task(noisy(i))
        return [(await q.get(), ms.now_ns()) for _ in range(5)]

    return run(ms, seed, main)


@scenario(COMPAT)
def sim_loop_facade_and_errors(ms, seed):
    aio = mod(ms, "compat.asyncio")

    async def main():
        loop = aio.get_event_loop()
        fired = []
        loop.call_later(0.25, lambda x: fired.append((x, ms.now_ns())), "cb")
        t = loop.create_task(aio.sleep(0.1, "task"))
        got = await t
        await aio.sleep(0.5)
        out = [got, fired, round(loop.time(), 6)]
        try:
            aio.run(None)
        except RuntimeError as e:
            out.append(norm(e))
        out.append(await attempt(aio.wait_for(42, timeout=1)))
        return out

    return run(ms, seed, main)


# ------------------------------------------------------------ services
class Greeter:
    """The tonic-example service shape (4 RPC kinds)."""

    SERVICE_NAME = "helloworld.Greeter"

    def __init__(self, ms):
        self.ms = ms

    async def say_hello(self, request):
        return {"message": f"Hello {request.message['name']}!"}

    async def lots_of_replies(self, request):
        for i in range(5):
            await self.ms.sleep(0.01)
            yield {"message": f"{request.message['name']}#{i}"}

    async def record_hellos(self, stream):
        names = []
        async for msg in stream:
            names.append(msg["name"])
        return {"message": f"Hello {', '.join(names)}!"}

    async def chat(self, stream):
        async for msg in stream:
            yield {"message": f"ack:{msg['name']}"}


def spawn_greeter(ms, h, ip="10.0.0.1", port=50051):
    grpc = mod(ms, "services.grpc")

    async def serve():
        await grpc.Server.builder().add_service(Greeter(ms)).serve(f"0.0.0.0:{port}")

    node = h.create_node().name("grpc-server").ip(ip).init(serve).build()
    return node, f"{ip}:{port}"


def spawn_etcd(ms, h, timeout_rate=0.0, ip="10.0.2.1", port=2379):
    etcd = mod(ms, "services.etcd")

    async def serve():
        await etcd.SimServer(timeout_rate=timeout_rate).serve(f"0.0.0.0:{port}")

    h.create_node().name("etcd").ip(ip).init(serve).build()
    return f"{ip}:{port}"


def status(e):
    """A gRPC ``Status`` as ``[code name, message]``, else the exception."""
    code = getattr(e, "code", None)
    return [code.name, norm(str(e))] if code is not None else norm(e)


async def grpc_attempt(aw):
    try:
        return ["ok", norm(await aw)]
    except Exception as e:  # the status is the outcome
        return status(e)


def kvs(kvlist):
    return [[kv.key, kv.value, kv.create_revision, kv.mod_revision, kv.version, kv.lease]
            for kv in kvlist]


def client_on(ms, h, name, ip, body):
    node = h.create_node().name(name).ip(ip).build()
    return node.spawn(body())


@scenario(SERVICES)
def grpc_four_shapes(ms, seed):
    grpc = mod(ms, "services.grpc")

    async def main():
        h = ms.Handle.current()
        _, addr = spawn_greeter(ms, h)

        async def client():
            await ms.sleep(0.1)
            ch = await grpc.connect(addr)
            c = grpc.service_client(Greeter, ch)
            out = [await c.say_hello({"name": "world"}), ms.now_ns()]
            stream = await c.lots_of_replies({"name": "x"})
            out.append([m["message"] async for m in stream])
            tx, reply = await c.record_hellos()
            for n in ("a", "b", "c"):
                await tx.send({"name": n})
            await tx.finish()
            out.append(await reply)
            tx, stream = await c.chat()
            for n in ("1", "2"):
                await tx.send({"name": n})
                out.append((await stream.message())["message"])
            await tx.finish()
            out.append(await stream.message())
            out.append(ms.now_ns())
            assert out[0] == {"message": "Hello world!"}
            assert out[2] == [f"x#{i}" for i in range(5)]
            return out

        return await client_on(ms, h, "client", "10.0.0.2", client)

    return run(ms, seed, main)


@scenario(SERVICES)
def grpc_unavailable_and_crashes(ms, seed):
    grpc = mod(ms, "services.grpc")

    async def main():
        h = ms.Handle.current()
        server, addr = spawn_greeter(ms, h)
        out = []

        async def invalid():
            return await grpc_attempt(grpc.connect("10.9.9.9:1"))

        out.append(await client_on(ms, h, "c0", "10.0.0.3", invalid))

        async def client():
            await ms.sleep(0.1)
            ch = await grpc.connect(addr)
            c = grpc.service_client(Greeter, ch)
            r = [await c.say_hello({"name": "a"})]
            tx, stream = await c.chat()
            await tx.send({"name": "x"})
            r.append((await stream.message())["message"])
            tx.drop()  # abandon the stream without its end marker
            await ms.sleep(1.0)
            r.append(await c.say_hello({"name": "after"}))
            h.kill(server)
            r.append(await grpc_attempt(c.say_hello({"name": "b"})))
            r.append(ms.now_ns())
            return r

        out.append(await client_on(ms, h, "client", "10.0.0.2", client))
        h.restart(server)
        await ms.sleep(0.2)
        for i in range(6):
            async def spin():
                ch = await grpc.connect(addr)
                c = grpc.service_client(Greeter, ch)
                while True:
                    await c.say_hello({"name": "spin"})

            node = h.create_node().name(f"victim{i}").ip(f"10.0.1.{i + 1}").build()
            node.spawn(spin())
            await ms.sleep(ms.thread_rng().random_float() * 0.5)
            h.kill(node)

        async def check():
            ch = await grpc.connect(addr)
            c = grpc.service_client(Greeter, ch)
            return (await c.say_hello({"name": "still-alive"}))["message"]

        out.append(await client_on(ms, h, "probe", "10.0.0.99", check))
        out.append(ms.now_ns())
        assert out[-2] == "Hello still-alive!"
        return out

    return run(ms, seed, main)


@scenario(SERVICES)
def grpc_codegen_end_to_end(ms, seed):
    grpc = mod(ms, "services.grpc")
    gen = mod(ms, "services.grpc_codegen")
    ns = gen.compile_proto(str(PROTO))

    class Full(ns.GreeterServicer):
        async def say_hello(self, request):
            if isinstance(request.message, ns.HelloRequest):
                return ns.HelloReply(message=f"Hello {request.message.name}!")
            return {"message": f"Hello {request.message['name']}!"}

        async def lots_of_replies(self, request):
            for i in range(3):
                yield {"message": f"#{i}"}

        async def lots_of_greetings(self, stream):
            names = [m["name"] async for m in stream]
            return {"message": ", ".join(names)}

        async def bidi_hello(self, stream):
            async for m in stream:
                yield {"message": f"ack:{m['name']}"}

    class Partial(ns.GreeterServicer):
        async def say_hello(self, request):
            return {"message": "only this one"}

    async def main():
        h = ms.Handle.current()
        for ip, svc in (("10.0.0.1", Full()), ("10.0.0.3", Partial())):
            async def serve(svc=svc):
                await grpc.Server.builder().add_service(svc).serve("0.0.0.0:50051")

            h.create_node().name(f"srv-{ip}").ip(ip).init(serve).build()

        async def client():
            await ms.sleep(0.1)
            c = ns.GreeterClient(await grpc.connect("10.0.0.1:50051"))
            out = [await c.say_hello({"name": "world"})]
            typed = await c.say_hello(ns.HelloRequest(name="typed"))
            out.append([type(typed).__name__, typed.message])
            stream = await c.lots_of_replies({"name": "x"})
            out.append([m["message"] async for m in stream])
            tx, reply = await c.lots_of_greetings()
            await tx.send({"name": "a"})
            await tx.send({"name": "b"})
            await tx.finish()
            out.append(await reply)
            tx, stream = await c.bidi_hello()
            await tx.send({"name": "z"})
            out.append((await stream.message())["message"])
            await tx.finish()
            p = ns.GreeterClient(await grpc.connect("10.0.0.3:50051"))
            out.append((await p.say_hello({"name": "x"}))["message"])
            out.append(await grpc_attempt(p.say_hello.__self__.channel.unary(
                "/helloworld.Greeter/lots_of_greetings", None)))
            out.append(ms.now_ns())
            return out

        return await client_on(ms, h, "cli", "10.0.0.2", client)

    return run(ms, seed, main)


@scenario(SERVICES)
def etcd_kv_txn_and_revisions(ms, seed):
    etcd = mod(ms, "services.etcd")

    async def main():
        h = ms.Handle.current()
        addr = spawn_etcd(ms, h)

        async def app():
            await ms.sleep(0.1)
            c = await etcd.Client.connect([addr])
            r1 = await c.put("k1", "v1")
            r2 = await c.put("k1", "v2", etcd.PutOptions(prev_kv=True))
            out = [r1, r2["header_revision"], kvs([r2["prev_kv"]])]
            g = await c.get("k1")
            out.append(kvs(g["kvs"]))
            await c.put("k2", "x")
            await c.put("other", "y")
            g = await c.get("k", etcd.GetOptions(prefix=True))
            out.append(kvs(g["kvs"]))
            out.append((await c.get("a", etcd.GetOptions(range_end=b"l", limit=1)))["count"])
            d = await c.delete("k", etcd.DeleteOptions(prefix=True, prev_kv=True))
            out.append([d["deleted"], kvs(d["prev_kvs"])])
            await c.put("k", "1")
            t = (etcd.Txn()
                 .when([etcd.Compare.value("k", "=", "1")])
                 .and_then([etcd.TxnOp.put("k", "2"), etcd.TxnOp.get("k")])
                 .or_else([etcd.TxnOp.put("k", "bad")]))
            r = await c.txn(t)
            out.append([r["succeeded"], r["header_revision"], len(r["responses"])])
            r = await c.txn(t)
            out.append([r["succeeded"], kvs((await c.get("k"))["kvs"])])
            out.append(await attempt(c.put("z", "v", etcd.PutOptions(lease=12345))))
            v = await c.txn(etcd.Txn().when([etcd.Compare.version("k", ">", 1)]))
            out.append(v["succeeded"])
            out.append(ms.now_ns())
            return out

        return await client_on(ms, h, "app", "10.0.2.2", app)

    return run(ms, seed, main)


@scenario(SERVICES)
def etcd_lease_lifecycle(ms, seed):
    etcd = mod(ms, "services.etcd")

    async def main():
        h = ms.Handle.current()
        addr = spawn_etcd(ms, h)

        async def app():
            await ms.sleep(0.1)
            c = await etcd.Client.connect([addr])
            lc = c.lease_client()
            lease = await lc.grant(ttl=3)
            out = [lease]
            await c.put("ephemeral", "x", etcd.PutOptions(lease=lease["id"]))
            out.append((await c.get("ephemeral"))["count"])
            for _ in range(4):
                await ms.sleep(1.0)
                keeper = await lc.keep_alive(lease["id"])
                out.append(await lc.time_to_live(lease["id"]))
            out.append(await keeper.keep_alive())
            out.append(await lc.leases())
            await ms.sleep(5.0)
            out.append((await c.get("ephemeral"))["count"])
            out.append(await attempt(lc.time_to_live(lease["id"])))
            other = await lc.grant(ttl=60, lease_id=77)
            out.append([other, await attempt(lc.grant(ttl=60, lease_id=77))])
            out.append(await lc.revoke(77))
            out.append(await attempt(lc.revoke(77)))
            out.append(ms.now_ns())
            return out

        return await client_on(ms, h, "app", "10.0.2.2", app)

    return run(ms, seed, main)


@scenario(SERVICES)
def etcd_election_campaign_observe(ms, seed):
    etcd = mod(ms, "services.etcd")

    async def main():
        h = ms.Handle.current()
        addr = spawn_etcd(ms, h)

        async def app():
            await ms.sleep(0.1)
            c1 = await etcd.Client.connect([addr])
            c2 = await etcd.Client.connect([addr])
            oc = await etcd.Client.connect([addr])
            l1 = await c1.lease_client().grant(ttl=60)
            l2 = await c2.lease_client().grant(ttl=60)
            e1, e2 = c1.election_client(), c2.election_client()
            stream = await oc.election_client().observe("mayor")
            seen = []

            async def observer():
                async for resp in stream:
                    seen.append((resp["kv"].value, ms.now_ns()))

            obs_task = ms.spawn(observer())
            win1 = await e1.campaign("mayor", "alice", l1["id"])
            out = [win1["name"], win1["rev"], (await e2.leader("mayor"))["kv"].value]
            second = ms.spawn(e2.campaign("mayor", "bob", l2["id"]))
            await ms.sleep(1.0)
            out.append(second.done())
            await e1.proclaim(win1["key"], "alice2")
            out.append((await e2.leader("mayor"))["kv"].value)
            await e1.resign(win1["key"])
            win2 = await second
            out.append((await e1.leader("mayor"))["kv"].value)
            await ms.sleep(0.5)
            await e2.resign(win2["key"])
            out.append(await attempt(e1.leader("mayor")))
            await ms.sleep(0.5)
            stream.close()
            await ms.sleep(0.5)
            out.append([seen, obs_task.done()])
            # lease expiry hands leadership over
            l3 = await c1.lease_client().grant(ttl=2)
            await e1.campaign("boss", "a", l3["id"])
            await e2.campaign("boss", "b", l2["id"])
            out.append([(await e2.leader("boss"))["kv"].value, ms.now_ns()])
            return out

        return await client_on(ms, h, "app", "10.0.2.2", app)

    return run(ms, seed, main)


@scenario(SERVICES)
def etcd_fault_injection(ms, seed):
    etcd = mod(ms, "services.etcd")

    async def main():
        h = ms.Handle.current()
        addr = spawn_etcd(ms, h, timeout_rate=1.0)
        half = spawn_etcd(ms, h, timeout_rate=0.5, ip="10.0.2.3")

        async def app():
            await ms.sleep(0.1)
            c = await etcd.Client.connect([addr])
            t0 = ms.now_ns()
            out = [await attempt(c.put("k", "v")), ms.now_ns() - t0]
            c2 = await etcd.Client.connect(half)
            for i in range(6):
                out.append([await attempt(c2.put(f"k{i}", "v")), ms.now_ns()])
            return out

        return await client_on(ms, h, "app", "10.0.2.2", app)

    return run(ms, seed, main, time_limit=200.0)


def kafka_broker(ms, h, ip):
    kafka = mod(ms, "services.kafka")

    async def serve():
        await kafka.SimBroker().serve("0.0.0.0:9092")

    h.create_node().name("broker").ip(ip).init(serve).build()
    return f"{ip}:9092"


@scenario(SERVICES)
def kafka_exactly_once_sum(ms, seed):
    kafka = mod(ms, "services.kafka")

    async def main():
        h = ms.Handle.current()
        addr = kafka_broker(ms, h, "10.0.3.1")

        async def mk_admin():
            await ms.sleep(0.1)
            a = await kafka.ClientConfig().set("bootstrap.servers", addr).create(
                kafka.AdminClient)
            await a.create_topics([kafka.NewTopic("events", 4)])

        await client_on(ms, h, "admin", "10.0.3.2", mk_admin)

        async def producer(base):
            p = await kafka.ClientConfig().set("bootstrap.servers", addr).create(
                kafka.FutureProducer)
            return [await p.send(kafka.BaseRecord.to("events").set_payload(str(base + i)))
                    for i in range(20)]

        p1 = h.create_node().name("p1").ip("10.0.3.3").build()
        p2 = h.create_node().name("p2").ip("10.0.3.4").build()
        j1, j2 = p1.spawn(producer(0)), p2.spawn(producer(1000))
        acks = [await j1, await j2]

        async def consumer(partitions):
            cfg = (kafka.ClientConfig().set("bootstrap.servers", addr)
                   .set("auto.offset.reset", "earliest"))
            c = await cfg.create(kafka.BaseConsumer)
            tpl = kafka.TopicPartitionList()
            for p in partitions:
                tpl.add_partition("events", p)
            await c.assign(tpl)
            got, idle = [], 0
            while idle < 20:
                msg = await c.poll()
                if msg is None:
                    idle += 1
                    await ms.sleep(0.05)
                else:
                    idle = 0
                    got.append([msg.partition, msg.offset, int(msg.payload)])
            return got

        c1 = h.create_node().name("c1").ip("10.0.3.5").build()
        c2 = h.create_node().name("c2").ip("10.0.3.6").build()
        g1, g2 = await c1.spawn(consumer([0, 1])), await c2.spawn(consumer([2, 3]))
        vals = sorted(v for *_po, v in g1 + g2)
        assert vals == sorted(list(range(20)) + list(range(1000, 1020)))
        return [acks, g1, g2, ms.now_ns()]

    return run(ms, seed, main)


@scenario(SERVICES)
def kafka_queue_full_transactions_stream(ms, seed):
    kafka = mod(ms, "services.kafka")

    async def main():
        h = ms.Handle.current()
        addr = kafka_broker(ms, h, "10.0.3.1")

        async def go():
            await ms.sleep(0.1)
            cfg = (kafka.ClientConfig().set("bootstrap.servers", addr)
                   .set("auto.offset.reset", "earliest"))
            a = await cfg.create(kafka.AdminClient)
            await a.create_topics([kafka.NewTopic("t", 3), kafka.NewTopic("tx", 1)])
            p = await cfg.create(kafka.BaseProducer)
            for i in range(10):
                p.send(kafka.BaseRecord.to("t").set_payload(str(i)))
            out = []
            try:
                p.send(kafka.BaseRecord.to("t").set_payload("x"))
            except kafka.KafkaError as e:
                out.append(norm(e))
            out.append(await p.flush())
            fp = await cfg.create(kafka.FutureProducer)
            out.append(await fp.send(kafka.BaseRecord.to("t").set_partition(2).set_payload("y")))
            tp = await cfg.create(kafka.BaseProducer)
            await tp.init_transactions()
            tp.begin_transaction()
            tp.send(kafka.BaseRecord.to("tx").set_payload("aborted"))
            tp.abort_transaction()
            tp.begin_transaction()
            tp.send(kafka.BaseRecord.to("tx").set_payload("committed"))
            await tp.commit_transaction()
            c = await cfg.create(kafka.StreamConsumer)
            tpl = kafka.TopicPartitionList()
            tpl.add_partition_offset("tx", 0, kafka.Offset("beginning"))
            await c.assign(tpl)
            msg = await c.recv()
            out.append([msg.payload, msg.offset, await c.fetch_watermarks("tx", 0)])
            out.append(ms.now_ns())
            return out

        return await client_on(ms, h, "app", "10.0.3.2", go)

    return run(ms, seed, main)


@scenario(SERVICES)
def kafka_consumer_group_split_and_rebalance(ms, seed):
    kafka = mod(ms, "services.kafka")

    async def main():
        h = ms.Handle.current()
        addr = kafka_broker(ms, h, "10.0.5.1")

        async def mk():
            await ms.sleep(0.1)
            cfg = kafka.ClientConfig().set("bootstrap.servers", addr)
            a = await cfg.create(kafka.AdminClient)
            await a.create_topics([kafka.NewTopic("jobs", 4)])
            p = await cfg.create(kafka.FutureProducer)
            for i in range(30):
                await p.send(kafka.BaseRecord.to("jobs").set_payload(str(i)))

        await client_on(ms, h, "setup", "10.0.5.2", mk)

        def ccfg():
            return (kafka.ClientConfig().set("bootstrap.servers", addr)
                    .set("group.id", "workers").set("auto.offset.reset", "earliest")
                    .set("session.timeout.ms", "2000").set("heartbeat.interval.ms", "300")
                    .set("auto.commit.interval.ms", "200"))

        async def victim():
            c = await ccfg().create(kafka.BaseConsumer)
            await c.subscribe(["jobs"])
            got = 0
            while got < 5:
                if await c.poll() is not None:
                    got += 1
                await ms.sleep(0.05)
            await c.commit()
            await ms.sleep(1000)

        async def survivor(results):
            c = await ccfg().create(kafka.BaseConsumer)
            await c.subscribe(["jobs"])
            first = c.assignment()
            idle = 0
            while idle < 40:
                m = await c.poll()
                if m is None:
                    idle += 1
                    await ms.sleep(0.2)
                else:
                    idle = 0
                    results.append([m.partition, int(m.payload), ms.now_ns()])
            assign = c.assignment()
            gen = c._generation
            await c.close()
            return [first, assign, gen]

        v = h.create_node().name("victim").ip("10.0.5.3").build()
        s = h.create_node().name("survivor").ip("10.0.5.4").build()
        v.spawn(victim())
        results = []
        j = s.spawn(survivor(results))
        await ms.sleep(2.0)
        h.kill(v.id)
        first, final, gen = await j
        assert set(map(tuple, final)) == {("jobs", p) for p in range(4)}
        assert len({r[1] for r in results}) >= 30 - 5
        return [first, final, gen, results, ms.now_ns()]

    return run(ms, seed, main)


@scenario(SERVICES)
def kafka_group_topic_created_after_subscribe(ms, seed):
    kafka = mod(ms, "services.kafka")

    async def main():
        h = ms.Handle.current()
        addr = kafka_broker(ms, h, "10.0.7.1")

        async def consume():
            cfg = (kafka.ClientConfig().set("bootstrap.servers", addr)
                   .set("group.id", "g").set("auto.offset.reset", "earliest")
                   .set("heartbeat.interval.ms", "100"))
            c = await cfg.create(kafka.BaseConsumer)
            await c.subscribe(["later"])
            empty = c.assignment()
            got = []
            for _ in range(60):
                m = await c.poll()
                if m is not None:
                    got.append([int(m.payload), ms.now_ns()])
                await ms.sleep(0.15)
            gen = c._generation
            await c.close()
            return [empty, got, gen]

        async def create_and_produce():
            await ms.sleep(1.0)
            cfg = kafka.ClientConfig().set("bootstrap.servers", addr)
            a = await cfg.create(kafka.AdminClient)
            await a.create_topics([kafka.NewTopic("later", 2)])
            p = await cfg.create(kafka.FutureProducer)
            for i in range(6):
                await p.send(kafka.BaseRecord.to("later").set_payload(str(i)))

        cn = h.create_node().name("c").ip("10.0.7.2").build()
        j = cn.spawn(consume())
        await client_on(ms, h, "a", "10.0.7.3", create_and_produce)
        empty, got, gen = await j
        assert empty == [] and sorted(g for g, _t in got) == list(range(6))
        return [got, gen]

    return run(ms, seed, main)


@scenario(SERVICES)
def grpc_and_etcd_interleaving(ms, seed):
    grpc, etcd = mod(ms, "services.grpc"), mod(ms, "services.etcd")

    async def main():
        h = ms.Handle.current()
        _, addr = spawn_greeter(ms, h)
        eaddr = spawn_etcd(ms, h)

        async def go():
            await ms.sleep(0.1)
            c = grpc.service_client(Greeter, await grpc.connect(addr))
            ec = await etcd.Client.connect([eaddr])
            events = []
            for i in range(5):
                r = await c.say_hello({"name": str(i)})
                w = await ec.put(f"k{i}", r["message"])
                events.append([ms.now_ns(), r["message"], w["header_revision"]])
            return events

        return await client_on(ms, h, "cli", "10.0.0.2", go)

    return run(ms, seed, main)


@scenario(SERVICES)
def kafka_consumer_group_splits_and_stabilizes(ms, seed):
    kafka = mod(ms, "services.kafka")

    async def main():
        h = ms.Handle.current()
        addr = kafka_broker(ms, h, "10.0.4.1")

        async def mk():
            await ms.sleep(0.1)
            cfg = kafka.ClientConfig().set("bootstrap.servers", addr)
            a = await cfg.create(kafka.AdminClient)
            await a.create_topics([kafka.NewTopic("jobs", 4)])
            p = await cfg.create(kafka.FutureProducer)
            for i in range(40):
                await p.send(kafka.BaseRecord.to("jobs").set_payload(str(i)))

        await client_on(ms, h, "setup", "10.0.4.2", mk)

        def ccfg():
            return (kafka.ClientConfig().set("bootstrap.servers", addr)
                    .set("group.id", "workers").set("auto.offset.reset", "earliest")
                    .set("session.timeout.ms", "5000").set("heartbeat.interval.ms", "100"))

        async def worker(results):
            c = await ccfg().create(kafka.BaseConsumer)
            await c.subscribe(["jobs"])
            idle = 0
            while idle < 30:
                m = await c.poll()
                if m is None:
                    idle += 1
                    await ms.sleep(0.15)
                else:
                    idle = 0
                    results.append([m.partition, int(m.payload), ms.now_ns()])
            out = [c.assignment(), c._generation]
            await c.close()
            return out

        n1 = h.create_node().name("c1").ip("10.0.4.3").build()
        n2 = h.create_node().name("c2").ip("10.0.4.4").build()
        r1, r2 = [], []
        j1, j2 = n1.spawn(worker(r1)), n2.spawn(worker(r2))
        (a1, g1), (a2, g2) = await j1, await j2
        assert len(a1) == 2 and len(a2) == 2 and not ({*map(tuple, a1)} & {*map(tuple, a2)})
        assert sorted(v for _p, v, _t in r1 + r2) == list(range(40))
        assert g1 == g2 and g1 <= 3
        return [a1, a2, g1, r1, r2, ms.now_ns()]

    return run(ms, seed, main)
