"""Scenario programs that hold the port's single-seed runtime against the
JAX package's.

A scenario is ``f(ms, seed) -> log``: one async program, written once
against a package object ``ms`` (``madsim_tpu`` or ``madsim_tpu_torch``),
run on a fresh ``Runtime(seed=seed)``. Its log is JSON-able and holds
what the program saw: virtual times, node and task ids, draws, messages
received, results, and the type and message of every exception, with the
package's name normalised (:func:`norm`). The tests assert that both
packages give equal logs, case by case.

The scenarios follow the JAX package's own tests of these layers
(``test_runtime.py``, ``test_intercept.py``, ``test_plugin.py``,
``test_trace.py``, ``test_net.py``, ``test_tcp_udp_fs.py``,
``test_unix.py``, ``test_aio_streams.py``, ``test_aio_interpose.py``,
``test_public_api.py``), recording values where those tests assert them.
"""

from __future__ import annotations

import asyncio
import contextlib
import importlib
import io
import logging
import os
import random
import tempfile
import threading
import time
import uuid

RUNTIME: dict = {}
NET: dict = {}
FS: dict = {}


def scenario(registry):
    def deco(f):
        registry[f.__name__] = f
        return f

    return deco


def mod(ms, path: str):
    """The package's submodule ``path`` (``"net.netsim"``)."""
    return importlib.import_module(f"{ms.__name__}.{path}")


def norm(x):
    """A JSON-able copy of ``x`` with the package's name normalised."""
    if isinstance(x, str):
        return x.replace("madsim_tpu_torch", "madsim_tpu")
    if x is None or isinstance(x, (bool, int, float)):
        return x
    if isinstance(x, (bytes, bytearray)):
        return "bytes:" + bytes(x).hex()
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, dict):
        return {str(norm(k)): norm(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return sorted((norm(v) for v in x), key=repr)
    if isinstance(x, BaseException):
        return ["exc", type(x).__name__, norm(str(x))]
    return "obj:" + type(x).__name__


def run(ms, seed, main, config=None, time_limit=60.0):
    """Run ``main()`` on a fresh runtime; the result or the exception."""
    rt = ms.Runtime(seed=seed, config=config)
    if time_limit is not None:
        rt.set_time_limit(time_limit)
    try:
        return ["ok", norm(rt.block_on(main()))]
    except Exception as e:  # the exception is the outcome
        return norm(e)


async def attempt(aw):
    """Await ``aw``; its result, or the exception it raised."""
    try:
        return ["ok", norm(await aw)]
    except (Exception, asyncio.CancelledError) as e:  # the exception is the outcome
        return norm(e)


def stamp(ms, timed):
    """The virtual time, where a scenario may log it.

    The JAX package's ``NetSim.reset_node`` closes a killed node's pipes
    in set order, that is in the order of the objects' addresses, so the
    time at which a peer sees the EOF varies from run to run there. The
    shared scenarios log no such time (``timed=False``); the port closes
    them in registration order, and its own test logs them."""
    return ms.now_ns() if timed else "after-kill"


KILL_TIMED = ("kill_gives_eof_and_send_error", "tcp_eof_on_reset_and_udp",
              "aio_stream_concurrent_clients_and_kill")


def two_nodes(h):
    a = h.create_node().name("a").ip("10.0.0.1").build()
    b = h.create_node().name("b").ip("10.0.0.2").build()
    return a, b


# ------------------------------------------------------------- runtime
@scenario(RUNTIME)
def spawn_join_nested(ms, seed):
    async def inner():
        await ms.sleep(0.25)
        return 7

    async def outer():
        return await ms.spawn(inner()) + 1

    async def main():
        v = await ms.spawn(outer())
        return [v, ms.now_ns()]

    return run(ms, seed, main)


@scenario(RUNTIME)
def sleep_order_and_clock(ms, seed):
    order = []

    async def sleeper(d, tag):
        await ms.sleep(d)
        order.append((tag, ms.now_ns()))

    async def main():
        start = ms.now()
        for d, tag in [(3.0, "c"), (1.0, "a"), (2.0, "b")]:
            ms.spawn(sleeper(d, tag))
        await ms.sleep(4.0)
        return [order, start.elapsed(), ms.now_ns()]

    return run(ms, seed, main)


@scenario(RUNTIME)
def random_schedule(ms, seed):
    order = []

    async def worker(i):
        order.append(i)
        await ms.yield_now()
        order.append(-i)

    async def main():
        for i in range(20):
            ms.spawn(worker(i))
        await ms.sleep(1.0)
        return order

    return run(ms, seed, main)


@scenario(RUNTIME)
def timeout_paths(ms, seed):
    cleaned = []

    async def slow():
        try:
            await ms.sleep(100.0)
        finally:
            cleaned.append(ms.now_ns())

    async def main():
        a = await attempt(ms.timeout(2.0, ms.sleep(1.0)))
        b = await attempt(ms.timeout(1.0, ms.sleep(10.0)))
        c = await attempt(ms.timeout(1.0, slow()))
        return [a, b, c, cleaned, ms.now_ns()]

    return run(ms, seed, main)


@scenario(RUNTIME)
def interval_ticks(ms, seed):
    async def main():
        it = ms.interval(1.0)
        ticks = []
        for _ in range(4):
            t = await it.tick()
            ticks.append(t.ns)
        return ticks

    return run(ms, seed, main)


@scenario(RUNTIME)
def kill_cleanup_and_join_error(ms, seed):
    JoinError = mod(ms, "runtime.task").JoinError
    cleaned = []

    async def victim():
        try:
            await ms.sleep(1000.0)
        finally:
            cleaned.append(("cleanup", ms.now_ns()))

    async def main():
        h = ms.Handle.current()
        node = h.create_node().name("victim-node").build()
        jh = node.spawn(victim())
        await ms.sleep(1.0)
        h.kill(node)
        try:
            await jh
            got = "no-error"
        except JoinError as e:
            got = [type(e).__name__, e.is_cancelled(), e.is_panic()]
        await ms.sleep(1.0)
        return [cleaned, got, node.id, ms.now_ns()]

    return run(ms, seed, main)


@scenario(RUNTIME)
def restart_replays_init(ms, seed):
    starts = []

    async def main():
        h = ms.Handle.current()

        async def init():
            starts.append(ms.now_ns())
            await ms.sleep(0.3)
            starts.append(("slept", ms.now_ns()))

        node = h.create_node().init(init).build()
        await ms.sleep(1.0)
        h.restart(node)
        await ms.sleep(1.0)
        return starts

    return run(ms, seed, main)


@scenario(RUNTIME)
def restart_on_panic(ms, seed):
    state = {"n": 0}
    beats = []

    async def main():
        h = ms.Handle.current()
        done = ms.SimFuture()

        async def init():
            state["n"] += 1
            if state["n"] == 2:
                done.set_result(ms.now_ns())
                return

            async def sibling():
                while True:
                    beats.append(ms.now_ns())
                    await ms.sleep(0.1)

            ms.spawn(sibling())
            await ms.sleep(0.5)
            raise RuntimeError("crash")

        h.create_node().init(init).restart_on_panic().build()
        t = await done
        return [state["n"], t, beats]

    return run(ms, seed, main)


@scenario(RUNTIME)
def pause_resume(ms, seed):
    progress = []

    async def worker():
        for i in range(10):
            progress.append((i, ms.now_ns()))
            await ms.sleep(1.0)

    async def main():
        h = ms.Handle.current()
        node = h.create_node().build()
        node.spawn(worker())
        await ms.sleep(2.5)
        h.pause(node)
        at_pause = len(progress)
        await ms.sleep(3.0)
        frozen = len(progress)
        h.resume(node)
        await ms.sleep(3.0)
        return [at_pause, frozen, progress]

    return run(ms, seed, main)


@scenario(RUNTIME)
def failures_fail_the_simulation(ms, seed):
    async def bad():
        raise ValueError("kaboom")

    async def panics():
        jh = ms.spawn(bad())
        await ms.sleep(1.0)
        try:
            await jh
        except Exception:
            return "caught"

    async def deadlock():
        await ms.SimFuture()

    async def long():
        await ms.sleep(100.0)

    return [
        run(ms, seed, panics),
        run(ms, seed, deadlock),
        run(ms, seed, long, time_limit=1.0),
    ]


@scenario(RUNTIME)
def select_and_join_all(ms, seed):
    async def val(x):
        await ms.sleep(0.1)
        return x

    async def main():
        idx, _ = await ms.select(ms.sleep(2.0), ms.sleep(1.0))
        r = await ms.join_all([ms.spawn(val(i)) for i in range(5)])
        idx2, _ = await ms.select(ms.spawn(val("slowish")), ms.sleep(0.01))
        return [idx, r, idx2, ms.now_ns()]

    return run(ms, seed, main)


@scenario(RUNTIME)
def node_lookup_and_chaos_by_name(ms, seed):
    async def main():
        h = ms.Handle.current()
        n = h.create_node().name("worker-a").ip("10.0.0.5").build()
        out = [
            h.get_node("worker-a").id, h.get_node(n.id).name,
            h.get_node(n).ip, h.get_node("absent") is None,
        ]
        ticks = []

        async def loop():
            while True:
                await ms.sleep(0.1)
                ticks.append(ms.now_ns())

        n.spawn(loop())
        await ms.sleep(0.55)
        h.pause("worker-a")
        frozen = len(ticks)
        await ms.sleep(0.5)
        out.append([frozen, len(ticks)])
        h.resume("worker-a")
        await ms.sleep(0.5)
        out.append(ticks)
        try:
            h.kill("absent")
            out.append("no-error")
        except LookupError as e:
            out.append(norm(e))
        return out

    return run(ms, seed, main)


@scenario(RUNTIME)
def check_determinism(ms, seed):
    async def wl():
        draws = []
        for _ in range(5):
            draws.append(ms.thread_rng().random_float())
            await ms.sleep(0.5)
        return draws

    state = {"runs": 0}

    async def leaky():
        state["runs"] += 1
        await ms.sleep(float(state["runs"]))
        ms.thread_rng().random_float()

    async def unhashable():
        return random.choice([[1], [2], [3]])

    out = []
    for w in (wl, leaky, unhashable):
        try:
            out.append(["ok", norm(ms.Runtime.check_determinism(seed=seed, workload=w))])
        except Exception as e:  # the exception is the outcome
            out.append(norm(e))
    return out


@scenario(RUNTIME)
def system_time_and_clock_skew(ms, seed):
    SystemTime = mod(ms, "runtime.time_").SystemTime

    async def main():
        h = ms.Handle.current()
        n = h.create_node().name("skewed").build()
        out = [SystemTime.now().timestamp(), h.time.base_unix_ns]
        wall = []

        async def probe():
            for _ in range(3):
                await ms.sleep(0.2)
                wall.append(SystemTime.now().unix_ns - h.time.base_unix_ns - ms.now_ns())

        p = n.spawn(probe())
        await ms.sleep(0.3)
        h.set_clock_skew(n, 250_000_000)
        await p
        out.append(wall)
        return out

    return run(ms, seed, main)


@scenario(RUNTIME)
def self_kill_and_cancel_on_drop(ms, seed):
    cleaned = []

    async def main():
        h = ms.Handle.current()
        node = h.create_node().build()

        async def suicidal():
            try:
                h.kill(node)
                await ms.sleep(10.0)
                cleaned.append("not-reached")
            finally:
                cleaned.append(("cleanup", ms.now_ns()))

        node.spawn(suicidal())
        await ms.sleep(1.0)

        async def victim():
            try:
                await ms.sleep(1000.0)
            finally:
                cleaned.append(("dropped", ms.now_ns()))

        async def quick():
            await ms.sleep(0.1)
            return "done"

        async with ms.spawn(victim()).cancel_on_drop():
            await ms.sleep(1.0)
        await ms.sleep(0.5)
        async with ms.spawn(quick()).cancel_on_drop() as jh:
            got = await jh
        return [cleaned, got, ms.now_ns()]

    return run(ms, seed, main)


@scenario(RUNTIME)
def yield_now_and_spawn_blocking(ms, seed):
    async def main():
        t0 = ms.now_ns()
        order = []

        async def other():
            order.append("other")

        ms.spawn(other())
        await ms.yield_now()
        order.append("self")
        v = await ms.spawn_blocking(lambda: 6 * 7)
        return [order, ms.now_ns() - t0, v]

    return run(ms, seed, main)


@scenario(RUNTIME)
def join_error_is_panic(ms, seed):
    JoinError = mod(ms, "runtime.task").JoinError

    async def main():
        h = ms.Handle.current()
        node = h.create_node().restart_on_panic().build()

        async def boom():
            raise ValueError("kaboom")

        jh = node.spawn(boom())
        await ms.sleep(0.1)
        try:
            await jh
            return "no-error"
        except JoinError as e:
            return [e.is_panic(), e.is_cancelled(), norm(e.__cause__), ms.now_ns()]

    return run(ms, seed, main)


@scenario(RUNTIME)
def thread_rng_draws(ms, seed):
    async def main():
        rng = ms.thread_rng()
        xs = [rng.randrange(0, 1000) for _ in range(4)]
        xs += [rng.random_float(), rng.random_bool(0.5), rng.randbytes(5),
               rng.getrandbits(40), rng.gauss(1.0, 2.0), rng.choice("abcdef"),
               ms.random()]
        seq = list(range(8))
        rng.shuffle(seq)
        xs.append(seq)
        return xs

    return run(ms, seed, main)


@scenario(RUNTIME)
def builder_env(ms, seed):
    keys = ("MADSIM_TEST_SEED", "MADSIM_TEST_NUM", "MADSIM_TEST_JOBS",
            "MADSIM_TEST_CHECK_DETERMINISM", "MADSIM_TEST_TIME_LIMIT",
            "MADSIM_TEST_CONFIG")
    saved = {k: os.environ.get(k) for k in keys}
    seen = []
    lock = threading.Lock()

    @ms.test
    async def body():
        v = ms.thread_rng().randrange(0, 1 << 30)
        await ms.sleep(0.5)
        with lock:
            seen.append((ms.Handle.current().seed, v, ms.now_ns()))
        return v

    @ms.test
    async def sleepy():
        await ms.sleep(5.0)

    @ms.test
    async def lossy():
        return [ms.Handle.current().config.net.packet_loss_rate,
                ms.Handle.current().config.net.send_latency]

    out = []
    err = io.StringIO()
    try:
        for k in keys:
            os.environ.pop(k, None)
        os.environ["MADSIM_TEST_SEED"] = str(seed + 10)
        os.environ["MADSIM_TEST_NUM"] = "3"
        out.append(body())
        os.environ["MADSIM_TEST_JOBS"] = "2"
        os.environ["MADSIM_TEST_NUM"] = "4"
        out.append(body())
        os.environ["MADSIM_TEST_JOBS"] = "1"
        os.environ["MADSIM_TEST_NUM"] = "1"
        os.environ["MADSIM_TEST_CHECK_DETERMINISM"] = "1"
        out.append(body())
        del os.environ["MADSIM_TEST_CHECK_DETERMINISM"]
        os.environ["MADSIM_TEST_TIME_LIMIT"] = "1.5"
        with contextlib.redirect_stderr(err):
            try:
                sleepy()
                out.append("no-error")
            except Exception as e:  # the exception is the outcome
                out.append(norm(e))
        del os.environ["MADSIM_TEST_TIME_LIMIT"]
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "sim.toml")
            with open(path, "w") as f:
                f.write("[net]\npacket_loss_rate = 0.25\nsend_latency = [0.002, 0.004]\n")
            os.environ["MADSIM_TEST_CONFIG"] = path
            out.append(lossy())
            out.append(ms.Config.from_file(path).hash())
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out.append(sorted(seen))
    out.append(err.getvalue())
    return out


@scenario(RUNTIME)
def stdlib_random_and_entropy(ms, seed):
    async def main():
        out = [random.random() for _ in range(3)]
        out += [random.randint(0, 10**9), random.uniform(1.0, 2.0),
                random.choice([1, 2, 3]), random.getrandbits(33),
                random.randbytes(6), random.gauss(0.0, 1.0),
                random.sample(range(100), 4), random.choices("xyz", k=5),
                random.randrange(5, 50, 5), random.triangular(0.0, 1.0),
                random.expovariate(2.0), random.betavariate(2.0, 3.0),
                random.normalvariate(1.0, 0.5)]
        seq = list(range(10))
        random.shuffle(seq)
        out.append(seq)
        out.append(os.urandom(16))
        out.append(str(uuid.uuid4()))
        try:
            random.seed(0)
            out.append("seeded")
        except RuntimeError as e:
            out.append(norm(e))
        return out

    return run(ms, seed, main)


@scenario(RUNTIME)
def stdlib_time_and_threads(ms, seed):
    async def main():
        out = [time.time(), time.time_ns(), time.monotonic(), time.monotonic_ns(),
               time.perf_counter(), time.perf_counter_ns()]
        m0 = time.monotonic_ns()
        time.sleep(1.5)
        out.append(time.monotonic_ns() - m0)
        await ms.sleep(5.0)
        out.append(time.time())
        try:
            threading.Thread(target=lambda: None).start()
            out.append("started")
        except RuntimeError as e:
            out.append(norm(e))
        return out

    return run(ms, seed, main)


@scenario(RUNTIME)
def available_parallelism(ms, seed):
    async def main():
        h = ms.Handle.current()
        got = {}

        async def probe():
            got["cores"] = ms.available_parallelism()
            got["cpu_count"] = os.cpu_count()

        node = h.create_node().cores(4).build()
        node.spawn(probe())
        await ms.sleep(1.0)
        return got

    return run(ms, seed, main)


@scenario(RUNTIME)
def custom_simulator_plugin(ms, seed):
    plugin = mod(ms, "runtime.plugin")

    class GpsSim(ms.Simulator):
        def __init__(self, rng, time, config, handle):
            super().__init__(rng, time, config, handle)
            self.fixes, self.created, self.resets = {}, [], []

        def create_node(self, node_id):
            self.created.append(node_id)
            self.fixes[node_id] = []

        def reset_node(self, node_id):
            self.resets.append(node_id)
            self.fixes[node_id] = []

        def read_fix(self):
            fix = (self.time.now_ns(), self.rng.randrange(0, 360))
            self.fixes[plugin.node()].append(fix)
            return fix

    log = []

    async def main():
        h = ms.Handle.current()
        gps = h.simulator(GpsSim)
        same = plugin.simulator(GpsSim) is gps
        n1 = h.create_node().name("rover-1").build()
        n2 = h.create_node().name("rover-2").build()

        async def roam():
            for _ in range(3):
                await ms.sleep(0.5)
                log.append((plugin.node(), gps.read_fix()))

        a, b = n1.spawn(roam()), n2.spawn(roam())
        await a
        await b
        pre = len(gps.fixes[n1.id])
        h.kill(n1)
        h.restart(n1)
        await ms.sleep(0.1)
        return [same, gps.created, gps.resets, pre, gps.fixes, log]

    rt = ms.Runtime(seed=seed)
    rt.add_simulator(GpsSim)
    out = [norm(rt.block_on(main()))]
    rt2 = ms.Runtime(seed=seed)

    async def early():
        ms.Handle.current().create_node().name("early").build()

    rt2.block_on(early())
    out.append(rt2.add_simulator(GpsSim).created)
    return out


def _capture(ms, seed, body, name):
    records = []

    class Sink(logging.Handler):
        def emit(self, record):
            records.append(self.format(record))

    sink = Sink()
    sink.setFormatter(ms.SimFormatter())
    sink.addFilter(ms.SimContextFilter())
    log = logging.getLogger(name)
    log.setLevel(logging.INFO)
    log.propagate = False
    log.addHandler(sink)
    try:
        out = run(ms, seed, lambda: body(log), time_limit=30)
        log.info("outside")
    finally:
        log.removeHandler(sink)
    return [out, records]


@scenario(RUNTIME)
def trace_records_and_spans(ms, seed):
    async def body(log):
        h = ms.Handle.current()
        node = h.create_node().name("srv").ip("10.0.0.1").build()

        async def worker(tag, delay):
            with ms.span(f"outer-{tag}"):
                log.info("enter %s", tag)
                await ms.sleep(delay)
                with ms.span(f"inner-{tag}"):
                    log.info("deep %s", tag)
                    await ms.sleep(delay)
                log.info("shallow %s", tag)
            log.info("exit %s", tag)

        t1 = node.spawn(worker("a", 0.3), name="wa")
        t2 = node.spawn(worker("b", 0.2), name="wb")
        await t1
        await t2
        log.info("main done")

    return _capture(ms, seed, body, "scenario_trace")


@scenario(RUNTIME)
def raw_asyncio_primitives(ms, seed):
    async def main():
        out = []
        t0 = ms.now_ns()
        await asyncio.sleep(3.0)
        await asyncio.sleep(0)
        out.append(ms.now_ns() - t0)
        q = asyncio.Queue(maxsize=2)
        ev = asyncio.Event()

        async def producer():
            for i in range(5):
                await asyncio.sleep(0.01)
                await q.put(i)
            ev.set()
            return "done"

        async def consumer():
            got = [(await q.get(), ms.now_ns()) for _ in range(5)]
            await ev.wait()
            return got

        out.append(await asyncio.gather(producer(), consumer()))
        lock, sem, cond = asyncio.Lock(), asyncio.Semaphore(2), asyncio.Condition()
        trail = []

        async def locked(i):
            async with sem:
                async with lock:
                    trail.append(("in", i, ms.now_ns()))
                    await asyncio.sleep(0.01)
            async with cond:
                await cond.wait_for(lambda: len(trail) >= 4)
                trail.append(("woke", i))

        async def notifier():
            await asyncio.sleep(0.2)
            async with cond:
                cond.notify_all()

        await asyncio.gather(*(locked(i) for i in range(4)), notifier())
        out.append(trail)
        barrier = asyncio.Barrier(3)
        passed = []

        async def party(i):
            await asyncio.sleep(0.01 * i)
            await barrier.wait()
            passed.append((i, ms.now_ns()))

        await asyncio.gather(*(party(i) for i in range(3)))
        out.append(passed)
        return out

    return run(ms, seed, main)


@scenario(RUNTIME)
def raw_asyncio_timeouts_and_cancels(ms, seed):
    async def main():
        out = []
        try:
            async with asyncio.timeout(0.05):
                await asyncio.sleep(10.0)
        except TimeoutError:
            out.append(("timeout", ms.now_ns()))
        out.append(await attempt(asyncio.wait_for(asyncio.sleep(10.0), 0.1)))
        out.append(await asyncio.wait_for(asyncio.sleep(0.01, "fine"), 1.0))
        out.append(await attempt(asyncio.wait_for(ms.sleep(100.0), timeout=0.05)))
        t = asyncio.get_event_loop().time()
        try:
            async with asyncio.timeout_at(t + 0.05):
                await asyncio.sleep(50.0)
        except TimeoutError:
            out.append(("timeout_at", ms.now_ns()))
        events = []

        async def slow():
            try:
                await asyncio.sleep(100.0)
            except asyncio.CancelledError:
                events.append(("cancelled", ms.now_ns()))
                raise

        task = asyncio.create_task(slow(), name="slowpoke")
        await asyncio.sleep(0.01)
        task.cancel()
        out.append(await attempt(task))

        async def stubborn():
            try:
                await asyncio.sleep(100.0)
            except asyncio.CancelledError:
                return "suppressed"

        t2 = asyncio.create_task(stubborn())
        await asyncio.sleep(0.01)
        t2.cancel()
        out.append(await t2)
        inner = asyncio.create_task(asyncio.sleep(0.2, "shielded"))
        out.append(await attempt(asyncio.wait_for(asyncio.shield(inner), 0.05)))
        out.append(await inner)
        done, pending = await asyncio.wait(
            [asyncio.create_task(asyncio.sleep(d, d)) for d in (0.01, 0.5)],
            timeout=0.1,
        )
        out.append([sorted(t.result() for t in done), len(pending)])
        for p in pending:
            p.cancel()
        out.append(events)
        out.append(asyncio.current_task().get_name())
        return out

    return run(ms, seed, main)


@scenario(RUNTIME)
def raw_asyncio_exceptions_and_groups(ms, seed):
    async def main():
        out = []

        async def boom(msg, d=0.01):
            await asyncio.sleep(d)
            raise RuntimeError(msg)

        out.append(await attempt(asyncio.create_task(boom("routed"))))
        out.append(norm(await asyncio.gather(
            boom("g1"), asyncio.sleep(0.02, "ok"), return_exceptions=True)))

        async def job(i):
            await asyncio.sleep(0.01 * (i + 1))
            return i * 10

        async with asyncio.TaskGroup() as tg:
            ts = [tg.create_task(job(i)) for i in range(4)]
        out.append([t.result() for t in ts])
        events = []

        async def slow():
            try:
                await asyncio.sleep(100.0)
            except asyncio.CancelledError:
                events.append(("sibling-cancelled", ms.now_ns()))
                raise

        try:
            async with asyncio.TaskGroup() as tg:
                tg.create_task(boom("tg-boom"))
                tg.create_task(slow())
        except* RuntimeError as eg:
            events.append(("group-raised", [str(e) for e in eg.exceptions]))
        out.append(events)
        got = []
        for fut in asyncio.as_completed([job(2), job(0), job(1)]):
            got.append(await fut)
        out.append(got)
        got, timed_out = [], 0
        for fut in asyncio.as_completed(
                [asyncio.sleep(0.01, 0.01), asyncio.sleep(5.0, 5.0)], timeout=0.1):
            try:
                got.append(await fut)
            except TimeoutError:
                timed_out += 1
        out.append([got, timed_out, ms.now_ns()])
        return out

    return run(ms, seed, main)


@scenario(RUNTIME)
def raw_asyncio_fuzzed_program(ms, seed):
    async def main():
        log = []
        q = asyncio.Queue(maxsize=3)
        lock = asyncio.Lock()

        async def actor(i):
            for step in range(6):
                op = random.randrange(5)
                if op == 0:
                    await asyncio.sleep(random.uniform(0.001, 0.05))
                elif op == 1:
                    try:
                        async with asyncio.timeout(random.uniform(0.005, 0.05)):
                            await q.get()
                            log.append((i, step, "got"))
                    except TimeoutError:
                        log.append((i, step, "timeout"))
                elif op == 2:
                    try:
                        async with asyncio.timeout(0.05):
                            await q.put(random.randrange(100))
                            log.append((i, step, "put"))
                    except TimeoutError:
                        log.append((i, step, "put-timeout"))
                elif op == 3:
                    async with lock:
                        await asyncio.sleep(0.002)
                        log.append((i, step, "locked", ms.now_ns()))
                else:
                    t = asyncio.create_task(asyncio.sleep(10.0))
                    await asyncio.sleep(0.001)
                    t.cancel()
                    log.append((i, step, "cancelled"))

        async with asyncio.TaskGroup() as tg:
            for i in range(5):
                tg.create_task(actor(i))
        log.append(("end", ms.now_ns()))
        return log

    return run(ms, seed, main)


@scenario(RUNTIME)
def raw_asyncio_under_node_kill(ms, seed):
    async def main():
        h = ms.Handle.current()
        state = {"progress": 0}

        async def victim():
            while True:
                await asyncio.sleep(0.01)
                state["progress"] += 1

        node = h.create_node().name("victim").build()
        node.spawn(victim())
        await ms.sleep(0.1)
        h.kill(node.id)
        at_kill = state["progress"]
        await ms.sleep(0.1)
        t0 = ms.now_ns()
        await ms.sleep(0.05)
        await asyncio.sleep(0.05)
        return [at_kill, state["progress"], ms.now_ns() - t0]

    return run(ms, seed, main)


@scenario(RUNTIME)
def unknown_awaitable_and_real_loop(ms, seed):
    class Weird:
        def __await__(self):
            yield "not-a-future"

    async def main():
        await Weird()

    async def real_main():
        loop_before = asyncio.get_running_loop()

        async def sim_main():
            await asyncio.sleep(0.01)
            return ms.now_ns()

        got = run(ms, seed, sim_main)
        return [got, asyncio.get_running_loop() is loop_before]

    return [run(ms, seed, main), asyncio.run(real_main())]


@scenario(RUNTIME)
def public_surface(ms, seed):
    names = ("Builder", "Config", "DeadlockError", "DeterminismError", "Elapsed",
             "FallibleTask", "Handle", "Instant", "Interval", "JoinError",
             "JoinHandle", "NetConfig", "NodeBuilder", "NodeHandle", "Runtime",
             "SimContextFilter", "SimFormatter", "SimFuture", "Simulator",
             "SystemTime", "TimeLimitError", "available_parallelism",
             "init_logger", "interval", "join_all", "main", "node", "now",
             "now_ns", "random", "select", "simulator", "sleep", "sleep_until",
             "span", "spawn", "spawn_blocking", "spawn_local", "test",
             "thread_rng", "timeout", "yield_now", "FsSim", "NetSim", "Endpoint",
             "TcpListener", "TcpStream", "UdpSocket", "fs", "net")
    out = [[n, hasattr(ms, n)] for n in names]
    sims = mod(ms, "runtime.runtime").DEFAULT_SIMULATORS
    out.append([c.__name__ for c in sims])
    out.append(sorted(n for n in dir(mod(ms, "runtime")) if not n.startswith("_")))
    out.append(sorted(n for n in dir(ms.net) if not n.startswith("_")))
    rt = ms.Runtime(seed=seed)
    out.append([type(rt.handle.simulator(ms.NetSim)).__name__,
                type(rt.handle.simulator(ms.FsSim)).__name__])
    return out


# ------------------------------------------------------------------ net
@scenario(NET)
def endpoint_send_recv_and_tags(ms, seed):
    Endpoint = ms.Endpoint

    async def main():
        h = ms.Handle.current()
        a, b = two_nodes(h)
        got = []

        async def server():
            ep = await Endpoint.bind("0.0.0.0:500")
            p2, s2 = await ep.recv_from(tag=2)
            p1, s1 = await ep.recv_from(tag=1)
            p7, s7 = await ep.recv_from(tag=7)
            got.append([p2, p1, p7, s7, ms.now_ns()])

        async def client():
            ep = await Endpoint.bind("0.0.0.0:0")
            await ep.send_to("10.0.0.2:500", 1, "one")
            await ms.sleep(0.5)
            await ep.send_to("10.0.0.2:500", 2, "two")
            await ep.send_to("10.0.0.2:500", 7, {"hello": "world"})
            return ep.local_addr

        b.spawn(server())
        await ms.sleep(0.1)
        local = await a.spawn(client())
        await ms.sleep(1.0)
        return [got, local]

    return run(ms, seed, main)


@scenario(NET)
def connection_ordered_and_refused(ms, seed):
    Endpoint = ms.Endpoint

    async def main():
        h = ms.Handle.current()
        a, b = two_nodes(h)
        out = ms.SimFuture()

        async def server():
            ep = await Endpoint.bind("0.0.0.0:600")
            _tx, rx, peer = await ep.accept1()
            got = [await rx.recv() for _ in range(50)]
            out.set_result((got, peer, ms.now_ns()))

        async def client():
            ep = await Endpoint.bind("0.0.0.0:0")
            tx, _rx = await ep.connect1("10.0.0.2:600")
            for i in range(50):
                await tx.send(i)
            return await attempt(ep.connect1("10.0.0.2:9999"))

        b.spawn(server())
        await ms.sleep(0.1)
        refused = await a.spawn(client())
        return [await out, refused]

    return run(ms, seed, main)


@scenario(NET)
def partition_stalls_and_recovers(ms, seed):
    Endpoint = ms.Endpoint

    async def main():
        h = ms.Handle.current()
        net = h.simulator(ms.NetSim)
        a, b = two_nodes(h)
        received = []
        ready = ms.SimFuture()

        async def server():
            ep = await Endpoint.bind("0.0.0.0:700")
            ready.set_result(None)
            _tx, rx, _ = await ep.accept1()
            while True:
                m = await rx.recv()
                if m is None:
                    return
                received.append((m, ms.now_ns()))

        async def client():
            ep = await Endpoint.bind("0.0.0.0:0")
            tx, _ = await ep.connect1("10.0.0.2:700")
            await tx.send("before")
            await ms.sleep(1.0)
            await tx.send("during-1")
            await tx.send("during-2")

        b.spawn(server())
        await ready
        a.spawn(client())
        await ms.sleep(1.0)
        net.clog_link(a, b)
        await ms.sleep(10.0)
        n_during = len(received)
        net.unclog_link(a, b)
        await ms.sleep(15.0)
        return [received, n_during]

    return run(ms, seed, main)


@scenario(NET)
def packet_loss_and_latency(ms, seed):
    Endpoint = ms.Endpoint

    def body(loss):
        async def main():
            h = ms.Handle.current()
            a, b = two_nodes(h)
            got = []

            async def server():
                ep = await Endpoint.bind("0.0.0.0:800")
                while True:
                    payload, _ = await ep.recv_from(tag=1)
                    got.append((payload, ms.now_ns()))

            async def client():
                ep = await Endpoint.bind("0.0.0.0:0")
                for i in range(20):
                    await ep.send_to("10.0.0.2:800", 1, i)

            b.spawn(server())
            await ms.sleep(0.1)
            a.spawn(client())
            await ms.sleep(5.0)
            return [got, h.simulator(ms.NetSim).stat.msg_count]

        return main

    out = []
    for loss in (1.0, 0.3, 0.0):
        cfg = ms.Config()
        cfg.net.packet_loss_rate = loss
        cfg.net.send_latency = (0.002, 0.02)
        out.append(run(ms, seed, body(loss), config=cfg))
    return out


@scenario(NET)
def kill_gives_eof_and_send_error(ms, seed, timed=False):
    Endpoint = ms.Endpoint

    async def main():
        h = ms.Handle.current()
        a, b = two_nodes(h)
        status = ms.SimFuture()

        async def server():
            ep = await Endpoint.bind("0.0.0.0:900")
            _tx, rx, _ = await ep.accept1()
            await rx.recv()

        async def client():
            ep = await Endpoint.bind("0.0.0.0:0")
            tx, rx = await ep.connect1("10.0.0.2:900")
            await tx.send("hi")
            eof = await rx.recv()
            status.set_result([eof, stamp(ms, timed), await attempt(tx.send("again"))])

        b.spawn(server())
        await ms.sleep(0.1)
        a.spawn(client())
        await ms.sleep(2.0)
        h.kill(b)
        return await status

    return run(ms, seed, main)


class Echo:
    def __init__(self, text):
        self.text = text


class Fail:
    pass


class PingReq:
    def __init__(self, n):
        self.n = n


@scenario(NET)
def rpc_echo_errors_and_timeouts(ms, seed):
    Endpoint = ms.Endpoint

    async def main():
        h = ms.Handle.current()
        net = h.simulator(ms.NetSim)
        a, b = two_nodes(h)
        ready = ms.SimFuture()

        async def server():
            ep = await Endpoint.bind("0.0.0.0:1000")

            async def on_echo(req):
                return f"echo: {req.text}"

            async def on_fail(_req):
                raise ValueError("handler exploded")

            ep.add_rpc_handler(Echo, on_echo)
            ep.add_rpc_handler(Fail, on_fail)
            ready.set_result(None)

        async def client():
            ep = await Endpoint.bind("0.0.0.0:0")
            out = [await attempt(ep.call("10.0.0.2:1000", Echo("hi")))]
            out.append(await attempt(ep.call("10.0.0.2:1000", Fail())))
            out.append(ms.now_ns())
            net.clog_node(b)
            for _ in range(3):
                out.append(await attempt(ep.call("10.0.0.2:1000", Echo("x"), timeout=1.0)))
            out.append(len(ep._mailbox.waiters) + len(ep._mailbox.msgs))
            net.unclog_node(b)
            out.append(await attempt(ep.call("10.0.0.2:1000", Echo("back"), timeout=1.0)))
            out.append(ms.now_ns())
            return out

        b.spawn(server())
        await ready
        return await a.spawn(client())

    return run(ms, seed, main, time_limit=120.0)


@scenario(NET)
def send_hooks_and_stat(ms, seed):
    Endpoint = ms.Endpoint

    async def main():
        h = ms.Handle.current()
        net = h.simulator(ms.NetSim)
        a, b = two_nodes(h)
        got = []

        async def server():
            ep = await Endpoint.bind("0.0.0.0:1200")
            while True:
                payload, _ = await ep.recv_from(tag=1)
                got.append((payload, ms.now_ns()))

        def drop_evens(_src, _dst, msg):
            return not (msg[0] == "dgram" and isinstance(msg[2], int) and msg[2] % 2 == 0)

        hook_id = net.add_send_hook(drop_evens)
        b.spawn(server())
        await ms.sleep(0.1)

        async def client(n):
            ep = await Endpoint.bind("0.0.0.0:0")
            for i in range(n):
                await ep.send_to("10.0.0.2:1200", 1, i)

        a.spawn(client(6))
        await ms.sleep(5.0)
        net.remove_send_hook(hook_id)
        a.spawn(client(3))
        await ms.sleep(5.0)
        return [got, hook_id, net.stat.msg_count]

    return run(ms, seed, main)


@scenario(NET)
def ports_localhost_and_namespaces(ms, seed):
    Endpoint = ms.Endpoint

    async def main():
        h = ms.Handle.current()
        a, b = two_nodes(h)
        got_a, got_b = [], []

        async def ports():
            e1 = await Endpoint.bind("0.0.0.0:0")
            e2 = await Endpoint.bind("0.0.0.0:0")
            await ms.UdpSocket.bind("0.0.0.0:53")
            await ms.TcpListener.bind("0.0.0.0:53")
            await Endpoint.bind("0.0.0.0:53")
            return [e1.local_addr, e2.local_addr, await attempt(Endpoint.bind("0.0.0.0:53"))]

        async def local_server(sink):
            ep = await Endpoint.bind("127.0.0.1:1400")
            while True:
                p, _ = await ep.recv_from(tag=1)
                sink.append(p)

        async def local_client(val):
            ep = await Endpoint.bind("127.0.0.1:0")
            await ep.send_to("127.0.0.1:1400", 1, val)

        out = [await a.spawn(ports())]
        a.spawn(local_server(got_a))
        b.spawn(local_server(got_b))
        await ms.sleep(0.1)
        a.spawn(local_client("from-a"))
        b.spawn(local_client("from-b"))
        await ms.sleep(5.0)
        out += [got_a, got_b]
        ep = await Endpoint.bind("0.0.0.0:0")
        out.append(await attempt(ep.send_to("10.0.0.2:500", 1, "x")))
        return out

    return run(ms, seed, main)


@scenario(NET)
def pipe_registry_across_connections(ms, seed):
    Endpoint = ms.Endpoint

    async def main():
        h = ms.Handle.current()
        net = h.simulator(ms.NetSim)
        a, b = two_nodes(h)
        seen = []

        async def server():
            ep = await Endpoint.bind("0.0.0.0:600")
            while True:
                _tx, rx, peer = await ep.accept1()
                seen.append(("accept", peer, ms.now_ns()))

                async def drain(rx=rx):
                    while (m := await rx.recv()) is not None:
                        seen.append((m, ms.now_ns()))

                ms.spawn(drain())

        async def client():
            ep = await Endpoint.bind("0.0.0.0:0")
            for i in range(12):
                tx, _rx = await ep.connect1("10.0.0.2:600")
                await tx.send(i)
                tx.close()

        b.spawn(server())
        await ms.sleep(0.1)
        await a.spawn(client())
        await ms.sleep(30.0)
        return [seen, sum(len(s) for s in net._pipes_by_node.values())]

    return run(ms, seed, main, time_limit=240.0)


@scenario(NET)
def directional_clogs_and_aliases(ms, seed):
    Endpoint = ms.Endpoint

    async def main():
        h = ms.Handle.current()
        net = h.simulator(ms.NetSim)
        a, b = two_nodes(h)
        got_a, got_b = [], []

        async def rx(sink, port):
            ep = await Endpoint.bind(f"0.0.0.0:{port}")
            while True:
                payload, _ = await ep.recv_from(tag=1)
                sink.append((payload, ms.now_ns()))

        b.spawn(rx(got_b, 600))
        a.spawn(rx(got_a, 600))
        await ms.sleep(0.1)

        async def send(to_ip, val):
            ep = await Endpoint.bind("0.0.0.0:0")
            await ep.send_to(f"{to_ip}:600", 1, val)

        steps = [
            (net.clog_node_in, net.unclog_node_in, (b,)),
            (net.clog_node_out, net.unclog_node_out, (b,)),
            (net.disconnect, net.connect, (b,)),
            (net.disconnect2, net.connect2, (a, b)),
            (net.clog_link_one_way, net.unclog_link_one_way, (a, b)),
        ]
        for i, (on, off, args) in enumerate(steps):
            on(*args)
            a.spawn(send("10.0.0.2", f"a2b-{i}"))
            b.spawn(send("10.0.0.1", f"b2a-{i}"))
            await ms.sleep(1.0)
            off(*args)
        a.spawn(send("10.0.0.2", "a2b-up"))
        await ms.sleep(0.5)
        return [got_a, got_b]

    return run(ms, seed, main)


@scenario(NET)
def live_config_and_rpc_hooks(ms, seed):
    Endpoint = ms.Endpoint

    async def main():
        h = ms.Handle.current()
        net = h.simulator(ms.NetSim)
        a, b = two_nodes(h)
        received, handled = [], []

        async def rx():
            ep = await Endpoint.bind("0.0.0.0:620")

            async def handle(req):
                handled.append(req.n)
                return req.n * 10

            ep.add_rpc_handler(PingReq, handle)
            while True:
                p, _ = await ep.recv_from(tag=3)
                received.append(p)

        b.spawn(rx())
        await ms.sleep(0.1)

        async def send(val):
            ep = await Endpoint.bind("0.0.0.0:0")
            await ep.send_to("10.0.0.2:620", 3, val)

        net.update_config(lambda c: setattr(c, "packet_loss_rate", 1.0))
        for i in range(5):
            a.spawn(send(i))
        await ms.sleep(1.0)
        net.update_config(lambda c: setattr(c, "packet_loss_rate", 0.0))
        a.spawn(send("after"))
        await ms.sleep(0.5)

        async def call(n, timeout=2.0):
            ep = await Endpoint.bind("0.0.0.0:0")
            return await attempt(ep.call("10.0.0.2:620", PingReq(n), timeout=timeout))

        out = [list(received), await a.spawn(call(1))]
        net.hook_rpc_req(a, PingReq, lambda req: req.n % 2 == 0)
        out += [await a.spawn(call(2)), await a.spawn(call(3, timeout=0.5))]
        net.hook_rpc_req(a, PingReq, None)
        net.hook_rpc_rsp(a, int, lambda rsp: False)
        out.append(await a.spawn(call(4, timeout=0.5)))
        net.hook_rpc_rsp(a, int, None)
        out += [await a.spawn(call(5)), handled, ms.now_ns()]
        return out

    return run(ms, seed, main)


@scenario(NET)
def endpoint_connect_send_recv(ms, seed):
    Endpoint = ms.Endpoint

    async def main():
        h = ms.Handle.current()
        a, b = two_nodes(h)
        done = ms.SimFuture()

        async def server():
            ep = await Endpoint.bind("0.0.0.0:650")
            payload, src = await ep.recv_from(tag=9)
            await ep.send_to(src, 9, payload * 2)

        async def client():
            ep = await Endpoint.connect("10.0.0.2:650")
            peer = ep.peer_addr
            await ep.send(9, 21)
            done.set_result([peer, await ep.recv(9), ms.now_ns()])

        b.spawn(server())
        await ms.sleep(0.1)
        a.spawn(client())
        out = await done
        ep = await Endpoint.bind("0.0.0.0:0")
        try:
            ep.peer_addr
            out.append("no-error")
        except OSError as e:
            out.append(norm(e))
        return out

    return run(ms, seed, main)


@scenario(NET)
def service_decorator(ms, seed):
    service_mod = mod(ms, "net.service")

    @service_mod.service
    class Counter:
        def __init__(self):
            self.n = 0

        @service_mod.rpc
        async def add(self, req: PingReq):
            self.n += req.n
            await ms.sleep(0.01)
            return self.n

        @service_mod.rpc
        async def echo(self, req: Echo):
            return req.text.upper()

    async def main():
        h = ms.Handle.current()
        a, b = two_nodes(h)

        async def server():
            await Counter().serve("0.0.0.0:7000")

        b.spawn(server())
        await ms.sleep(0.1)

        async def client():
            ep = await ms.Endpoint.bind("0.0.0.0:0")
            out = []
            for i in range(1, 4):
                out.append(await ep.call("10.0.0.2:7000", PingReq(i)))
            out.append(await ep.call("10.0.0.2:7000", Echo("shout")))
            out.append(ms.now_ns())
            return out

        return await a.spawn(client())

    return run(ms, seed, main)


@scenario(NET)
def gray_failures_and_duplication(ms, seed):
    Endpoint = ms.Endpoint

    async def main():
        h = ms.Handle.current()
        net = h.simulator(ms.NetSim)
        a, b = two_nodes(h)
        got = []

        async def server():
            ep = await Endpoint.bind("0.0.0.0:700")
            while True:
                msg, _ = await ep.recv_from(1)
                got.append((msg, ms.now_ns()))

        async def client():
            ep = await Endpoint.bind("0.0.0.0:0")
            net.set_duplicate(True)
            await ep.send_to("10.0.0.2:700", 1, "x")
            await ms.sleep(0.5)
            net.set_duplicate(False)
            net.slow_link(a, b, 8)
            await ep.send_to("10.0.0.2:700", 1, "slow")
            await ms.sleep(0.5)
            net.slow_node(a, 3)
            mults = [net.network.slow_mult(a.id, b.id), net.network.slow_mult(b.id, a.id)]
            await ep.send_to("10.0.0.2:700", 1, "node-slow")
            await ms.sleep(0.5)
            net.slow_node(a, 1)
            net.unslow_link(a, b)
            await ep.send_to("10.0.0.2:700", 1, "healed")
            await ms.sleep(0.5)
            return mults + [net.network.slow_mult(a.id, b.id), net._duplicate]

        b.spawn(server())
        await ms.sleep(0.1)
        out = await a.spawn(client())
        return [out, got]

    return run(ms, seed, main, time_limit=5.0)


@scenario(NET)
def tcp_streams(ms, seed):
    async def main():
        h = ms.Handle.current()
        net = h.simulator(ms.NetSim)
        a, b = two_nodes(h)
        out = ms.SimFuture()
        received = []

        async def server():
            lis = await ms.TcpListener.bind("0.0.0.0:80")
            stream, peer = await lis.accept()
            data = await stream.read_exact(11)
            await stream.write_all(b"pong:" + data)
            stream2, _ = await lis.accept()
            while True:
                chunk = await stream2.read(1024)
                if not chunk:
                    return
                received.append((chunk, ms.now_ns()))

        async def client():
            s = await ms.TcpStream.connect("10.0.0.2:80")
            await s.write(b"hello")
            await s.write(b" world")
            await s.flush()
            r1 = await s.read(4)
            rest = await s.read_exact(12)
            out.set_result([r1 + rest, ms.now_ns()])
            s2 = await ms.TcpStream.connect("10.0.0.2:80")
            await s2.write_all(b"one")
            await ms.sleep(2.0)
            await s2.write_all(b"two")

        b.spawn(server())
        await ms.sleep(0.1)
        a.spawn(client())
        first = await out
        await ms.sleep(1.0)
        net.clog_link(a, b)
        await ms.sleep(10.0)
        during = list(received)
        net.unclog_link(a, b)
        await ms.sleep(15.0)
        return [first, during, received]

    return run(ms, seed, main)


@scenario(NET)
def tcp_eof_on_reset_and_udp(ms, seed, timed=False):
    async def main():
        h = ms.Handle.current()
        a, b = two_nodes(h)
        got = ms.SimFuture()
        dgram = ms.SimFuture()

        async def server():
            lis = await ms.TcpListener.bind("0.0.0.0:80")
            stream, _ = await lis.accept()
            await stream.read(1)

        async def client():
            s = await ms.TcpStream.connect("10.0.0.2:80")
            got.set_result([await s.read(10), stamp(ms, timed)])

        async def udp_server():
            sock = await ms.UdpSocket.bind("0.0.0.0:53")
            data, src = await sock.recv_from()
            await sock.send_to(b"resp:" + data, src)

        async def udp_client():
            sock = await ms.UdpSocket.bind("0.0.0.0:0")
            await sock.connect("10.0.0.2:53")
            await sock.send(b"query")
            dgram.set_result([await sock.recv(), ms.now_ns()])

        b.spawn(server())
        b.spawn(udp_server())
        await ms.sleep(0.1)
        a.spawn(client())
        a.spawn(udp_client())
        await ms.sleep(2.0)
        h.kill(b)
        return [await got, await dgram]

    return run(ms, seed, main)


@scenario(NET)
def unix_sockets(ms, seed):
    net = ms.net

    async def main():
        h = ms.Handle.current()
        a = h.create_node().name("a").build()
        b = h.create_node().name("b").build()
        res = []

        async def server():
            lis = await net.UnixListener.bind("/tmp/app.sock")
            stream, _peer = await lis.accept()
            data = await stream.read_exact(11)
            await stream.write_all(b"pong:" + data)
            s, _ = await lis.accept()
            chunks = []
            while True:
                c = await s.read(64)
                if not c:
                    break
                chunks.append(c)
            await s.write_all(b"got:" + b"".join(chunks))

        async def client():
            s = await net.UnixStream.connect("/tmp/app.sock")
            await s.write(b"hello")
            await s.write(b" world")
            await s.flush()
            r1 = await s.read(4)
            res.append(r1 + await s.read_exact(12))
            s2 = await net.UnixStream.connect("/tmp/app.sock")
            await s2.write_all(b"abc")
            s2.shutdown()
            res.append(await s2.read_exact(7))

        async def on_b():
            res.append(await attempt(net.UnixStream.connect("/tmp/app.sock")))

        async def dgrams():
            srv = await net.UnixDatagram.bind("/dg/server")
            cli = await net.UnixDatagram.bind("/dg/client")
            await cli.connect("/dg/server")
            await cli.send(b"ping")
            data, src = await srv.recv_from()
            await srv.send_to(b"re:" + data, src)
            res.append([src, await cli.recv()])
            res.append(await attempt(net.UnixListener.bind("/tmp/app.sock")))
            sock = await net.UnixDatagram.unbound()
            res.append(await attempt(sock.send_to(b"x", "/nowhere")))

        a.spawn(server())
        await ms.sleep(0.1)
        await a.spawn(client())
        await b.spawn(on_b())
        await a.spawn(dgrams())
        res.append(ms.now_ns())
        return res

    return run(ms, seed, main)


def _echo_cluster(ms, transcript):
    async def main():
        h = ms.Handle.current()

        async def serve():
            async def on_client(reader, writer):
                while True:
                    line = await reader.readline()
                    if not line:
                        break
                    writer.write(b"echo:" + line)
                    await writer.drain()
                writer.close()
                await writer.wait_closed()

            server = await asyncio.start_server(on_client, "10.0.0.1", 8000)
            async with server:
                await server.serve_forever()

        h.create_node().name("server").ip("10.0.0.1").init(serve).build()
        cli = h.create_node().name("client").ip("10.0.0.2").build()

        async def client():
            await asyncio.sleep(0.05)
            reader, writer = await asyncio.open_connection("10.0.0.1", 8000)
            transcript.append(writer.get_extra_info("peername"))
            for i in range(3):
                writer.write(f"msg{i}\n".encode())
                await writer.drain()
                line = await reader.readline()
                transcript.append((line, ms.now_ns()))
            writer.write_eof()
            tail = await reader.read()
            writer.close()
            return tail

        return await cli.spawn(client())

    return main


@scenario(NET)
def aio_stream_echo(ms, seed):
    transcript = []
    out = run(ms, seed, _echo_cluster(ms, transcript))
    return [out, norm(transcript)]


@scenario(NET)
def aio_stream_concurrent_clients_and_kill(ms, seed, timed=False):
    async def main():
        h = ms.Handle.current()
        peers = []

        async def serve():
            async def on_client(reader, writer):
                peers.append(writer.get_extra_info("peername"))
                data = await reader.readline()
                writer.write(data.upper())
                await writer.drain()
                writer.close()

            server = await asyncio.start_server(on_client, "10.0.0.1", 9000)
            async with server:
                await server.serve_forever()

        srv = h.create_node().name("server").ip("10.0.0.1").init(serve).build()

        async def one(i):
            await asyncio.sleep(0.01)
            r, w = await asyncio.open_connection("10.0.0.1", 9000)
            w.write(f"hello-{i}\n".encode())
            await w.drain()
            out = await r.readline()
            w.close()
            return [out, ms.now_ns()]

        outs = []
        for i in range(3):
            node = h.create_node().name(f"c{i}").ip(f"10.0.0.{i + 2}").build()
            outs.append(node.spawn(one(i)))
        res = [await o for o in outs]

        async def held():
            r, w = await asyncio.open_connection("server", 9000)
            await asyncio.sleep(0.5)
            try:
                w.write(b"x\n")
                await w.drain()
                return ["read", await r.read(), stamp(ms, timed)]
            except Exception as e:  # the exception is the outcome
                return norm(e)

        c = h.create_node().name("late").ip("10.0.0.9").build()
        jh = c.spawn(held())
        await ms.sleep(0.2)
        h.kill(srv)
        return [res, peers, await jh]

    return run(ms, seed, main)


@scenario(NET)
def aio_stream_reads_and_half_close(ms, seed):
    async def main():
        h = ms.Handle.current()

        async def serve():
            async def on_client(reader, writer):
                head = await reader.readexactly(4)
                body = await reader.readuntil(b"|")
                rest = await reader.read()
                writer.write(b"[" + head + b"/" + body + b"/" + rest + b"]")
                await writer.drain()
                writer.close()

            server = await asyncio.start_server(on_client, "10.0.0.1", 8100)
            async with server:
                await server.serve_forever()

        h.create_node().name("server").ip("10.0.0.1").init(serve).build()
        cli = h.create_node().name("client").ip("10.0.0.2").build()

        async def client():
            await asyncio.sleep(0.05)
            r, w = await asyncio.open_connection("10.0.0.1", 8100)
            w.write(b"HEADbody|tail")
            await w.drain()
            w.write_eof()
            got = await r.read()
            err = None
            try:
                await r.readexactly(1)
            except asyncio.IncompleteReadError as e:
                err = [type(e).__name__, e.partial, e.expected]
            w.close()
            return [got, err, ms.now_ns()]

        return await cli.spawn(client())

    return run(ms, seed, main)


@scenario(NET)
def aio_stream_clog_stall(ms, seed):
    async def main():
        h = ms.Handle.current()
        net = h.simulator(ms.NetSim)
        got = []

        async def serve():
            async def on_client(reader, writer):
                while line := await reader.readline():
                    got.append((line, ms.now_ns()))

            server = await asyncio.start_server(on_client, "10.0.0.1", 8200)
            async with server:
                await server.serve_forever()

        srv = h.create_node().name("server").ip("10.0.0.1").init(serve).build()
        cli = h.create_node().name("client").ip("10.0.0.2").build()

        async def client():
            await asyncio.sleep(0.05)
            r, w = await asyncio.open_connection("10.0.0.1", 8200)
            for i in range(4):
                w.write(f"l{i}\n".encode())
                await w.drain()
                await asyncio.sleep(0.5)
            w.close()

        jh = cli.spawn(client())
        await ms.sleep(0.8)
        net.clog_link(srv, cli)
        await ms.sleep(3.0)
        during = len(got)
        net.unclog_link(srv, cli)
        await jh
        await ms.sleep(3.0)
        return [during, got]

    return run(ms, seed, main)


@scenario(NET)
def aio_datagram_endpoint(ms, seed):
    async def main():
        h = ms.Handle.current()
        got = []

        class Proto(asyncio.DatagramProtocol):
            def connection_made(self, transport):
                self.t = transport

            def datagram_received(self, data, addr):
                got.append((data, addr, ms.now_ns()))
                self.t.sendto(b"ack:" + data, addr)

        async def serve():
            loop = asyncio.get_running_loop()
            await loop.create_datagram_endpoint(Proto, local_addr=("10.0.0.1", 5353))
            await asyncio.sleep(100.0)

        h.create_node().name("dns").ip("10.0.0.1").init(serve).build()
        cli = h.create_node().name("client").ip("10.0.0.2").build()

        async def client():
            await asyncio.sleep(0.05)
            loop = asyncio.get_running_loop()
            acks = []
            done = loop.create_future()

            class C(asyncio.DatagramProtocol):
                def datagram_received(self, data, addr):
                    acks.append((data, ms.now_ns()))
                    if len(acks) == 3 and not done.done():
                        done.set_result(None)

            t, _ = await loop.create_datagram_endpoint(C, remote_addr=("10.0.0.1", 5353))
            for i in range(3):
                t.sendto(f"q{i}".encode())
            await asyncio.wait_for(done, 2.0)
            t.close()
            return acks

        return [await cli.spawn(client()), got]

    return run(ms, seed, main)


# ------------------------------------------------------------------- fs
@scenario(FS)
def fs_read_write_metadata(ms, seed):
    fs = ms.fs

    async def main():
        h = ms.Handle.current()
        node = h.create_node().ip("10.0.0.1").build()

        async def work():
            out = []
            f = await fs.File.create("/data/log")
            await f.write_all_at(b"hello", 0)
            await f.write_all_at(b"world", 5)
            out.append(await f.read_at(10, 0))
            out.append((await f.metadata()).len)
            await f.set_len(5)
            out.append(await fs.read("/data/log"))
            await f.set_len(8)
            out.append(await f.read_at(100, 0))
            await f.write_all_at(b"!", 12)
            out.append([await f.read_at(100, 0), (await fs.metadata("/data/log")).len])
            out.append(await attempt(fs.File.open("/missing")))
            out.append(await attempt(fs.metadata("/missing")))
            await fs.write("/data/log", b"new")
            out.append(await fs.read("/data/log"))
            g = await fs.File.open_or_create("/data/other")
            out.append([g.path, await g.read_at(4, 0)])
            out.append(h.simulator(ms.FsSim).get_file_size(node.id, "/data/log"))
            out.append(h.simulator(ms.FsSim).get_file_size(node.id, "/nope"))
            return out

        return await node.spawn(work())

    return run(ms, seed, main)


@scenario(FS)
def fs_is_per_node(ms, seed):
    fs = ms.fs

    async def main():
        h = ms.Handle.current()
        a, b = two_nodes(h)

        async def on_a():
            await fs.write("/shared", b"from-a")
            return await fs.read("/shared")

        async def on_b():
            return await attempt(fs.read("/shared"))

        return [await a.spawn(on_a()), await b.spawn(on_b())]

    return run(ms, seed, main)


@scenario(FS)
def fs_power_failure_drops_unsynced(ms, seed):
    fs = ms.fs

    async def main():
        h = ms.Handle.current()
        node = h.create_node().ip("10.0.0.1").build()
        phase1 = ms.SimFuture()

        async def writer():
            f = await fs.File.create("/db")
            await f.write_all_at(b"durable", 0)
            await f.sync_all()
            await f.write_all_at(b"volatile", 7)
            g = await fs.File.create("/never-synced")
            await g.write_all_at(b"gone", 0)
            phase1.set_result(None)
            await ms.sleep(100.0)

        node.spawn(writer())
        await phase1
        h.kill(node)

        async def reader():
            return [await fs.read("/db"), await fs.read("/never-synced")]

        return await node.spawn(reader())

    return run(ms, seed, main)


@scenario(FS)
def fs_torn_writes(ms, seed):
    fs = ms.fs

    async def main():
        h = ms.Handle.current()
        sim = h.simulator(ms.FsSim)
        nodes = [h.create_node().name(f"n{i}").build() for i in range(4)]
        out = []
        for rnd in range(3):
            async def writer(i):
                f = await fs.File.open_or_create("/wal")
                await f.write_all_at(b"base-" + bytes([48 + i]), 0)
                await f.sync_all()
                await f.write_all_at(b"0123456789abcdef" * (i + 1), 6)

            for i, n in enumerate(nodes):
                sim.set_torn(n.id, rnd != 1 or i % 2 == 0)
                await n.spawn(writer(i))
                h.kill(n)

            async def reader():
                return await fs.read("/wal")

            out.append([await n.spawn(reader()) for n in nodes])
        return out

    return run(ms, seed, main)


@scenario(FS)
def fs_sync_loss_and_write_errors(ms, seed):
    fs = ms.fs

    async def main():
        h = ms.Handle.current()
        sim = h.simulator(ms.FsSim)
        n = h.create_node().name("disk").build()

        async def step(tag):
            f = await fs.File.open_or_create("/state")
            r = [await attempt(f.write_all_at(tag, 0))]
            r.append(await attempt(f.set_len(len(tag))))
            await f.sync_all()
            return r

        async def reader():
            return await fs.read("/state")

        out = [await n.spawn(step(b"first"))]
        sim.set_sync_loss(n.id, True)
        out.append(await n.spawn(step(b"lied")))
        h.kill(n)
        out.append(await n.spawn(reader()))
        sim.set_sync_loss(n.id, False)
        sim.set_fail_writes(n.id, True)
        out.append(await n.spawn(step(b"eio")))
        sim.set_fail_writes(n.id, False)
        out.append(await n.spawn(step(b"second")))
        h.kill(n)
        out.append(await n.spawn(reader()))
        return out

    return run(ms, seed, main)


@scenario(FS)
def fs_restart_reloads_synced_state(ms, seed):
    fs = ms.fs
    loads = []

    async def main():
        h = ms.Handle.current()

        async def init():
            try:
                blob = await fs.read("/counter")
            except FileNotFoundError:
                blob = b"0"
            n = int(blob)
            loads.append((n, ms.now_ns()))
            while True:
                n += 1
                f = await fs.File.open_or_create("/counter")
                await f.set_len(0)
                await f.write_all_at(str(n).encode(), 0)
                if n % 3 == 0:
                    await f.sync_all()
                await ms.sleep(0.05 + random.random() * 0.05)

        node = h.create_node().name("svc").init(init).build()
        for _ in range(3):
            await ms.sleep(0.7)
            h.kill(node)
            await ms.sleep(0.1)
            h.restart(node)
        await ms.sleep(0.2)
        return loads

    return run(ms, seed, main)
