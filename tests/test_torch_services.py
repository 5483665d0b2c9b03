"""The port's service simulators (gRPC and its codegen, etcd, Kafka)
against the JAX package's.

In the simulation: each scenario of ``_torch_scenarios_services.SERVICES``
(after ``tests/test_services.py`` and ``tests/test_grpc_codegen.py``)
runs on both packages at seeds 0, 1 and 7 and must give an equal log
that ends in a result; the generated classes of a ``.proto`` equal the
JAX package's. The dual seam (``services/_dual.py``) sees only its own
package's simulation. Over real loopback TCP (``tests/test_dual_mode.py``):
the port's servers and clients, and a port client against a JAX package
server and the reverse, on the one wire format. Every server binds
port 0. Last, the port's copy of ``examples/greeter.py``
(``tests/_torch_greeter.py``) gives the example's replies, in the
simulation and over loopback.
"""

import _torch_threads  # noqa: F401
import asyncio
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

import madsim_tpu as jms
import madsim_tpu_torch as tms
from _torch_scenarios_services import PROTO, SERVICES
from madsim_tpu.services import _dual as j_dual
from madsim_tpu.services import etcd as j_etcd
from madsim_tpu.services import grpc as j_grpc
from madsim_tpu.services import grpc_codegen as j_gen
from madsim_tpu_torch.services import _dual as t_dual
from madsim_tpu_torch.services import etcd as t_etcd
from madsim_tpu_torch.services import grpc as t_grpc
from madsim_tpu_torch.services import grpc_codegen as t_gen
from madsim_tpu_torch.services import kafka as t_kafka

ROOT = Path(__file__).resolve().parent.parent
SEEDS = (0, 1, 7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SERVICES))
def test_scenario_matches_the_jax_package(name, seed):
    f = SERVICES[name]
    got = f(tms, seed)
    assert got == f(jms, seed)
    assert got[0] == "ok", got


# ------------------------------------------------------------- codegen
TYPED_SRC = """
syntax = "proto3";
package shop;

enum Status {
  STATUS_UNKNOWN = 0;
  STATUS_PAID = 1;
  STATUS_SHIPPED = 2;
}

message Item {
  string sku = 1;
  uint32 count = 2;
  repeated string tags = 3;
}

message Order {
  uint64 id = 1;
  Status status = 2;
  repeated Item items = 3;
  map<string, int64> totals = 4;
  message Address { string city = 1; }
  Address ship_to = 5;
  oneof payment {
    string card = 6;
    string invoice = 7;
  }
}

message Transfer { string from = 1; string to = 2; bool in = 3; }

service Orders {
  rpc Place (Order) returns (Order);
  rpc Track (Order) returns (stream Item);
}
"""


def _surface(ns):
    """What a compiled namespace generates: each class's name, service
    name, method shapes, proto fields and defaults, and enum values."""
    out = {}
    for name in sorted(vars(ns)):
        obj = getattr(ns, name)
        if not isinstance(obj, type):
            continue
        entry = [obj.__name__, getattr(obj, "SERVICE_NAME", None),
                 getattr(obj, "__proto_fields__", None)]
        entry.append(sorted((m, getattr(getattr(obj, m), "__rpc_shape__", None))
                            for m in vars(obj) if not m.startswith("_")))
        if hasattr(obj, "__proto_fields__"):
            entry.append(repr(vars(obj())))
        out[name] = entry
    return out


@pytest.mark.parametrize("src", ["typed", "helloworld", "comments"])
def test_generated_classes_equal_the_jax_package(src):
    text = {
        "typed": TYPED_SRC,
        "helloworld": PROTO.read_text(),
        "comments": ("// comment with rpc Fake (A) returns (B);\npackage a.b;\n"
                     "service S {\n  rpc DoThing (X) returns (stream Y); /* inline */\n}\n"),
    }[src]
    got = _surface(t_gen.compile_proto_source(text))
    assert got == _surface(j_gen.compile_proto_source(text))
    assert got


def test_typed_messages_pickle_across_the_packages():
    """A generated message pickles through its own package's registry,
    and one package's message restores in a process where both compiled
    the same ``.proto``."""
    tns, jns = t_gen.compile_proto_source(TYPED_SRC), j_gen.compile_proto_source(TYPED_SRC)
    order = tns.Order(id=9, status=tns.Status.STATUS_SHIPPED,
                      items=[tns.Item(sku="s", count=1)], totals={"chf": 42},
                      ship_to=tns.Order_Address(city="Bern"))
    back = pickle.loads(pickle.dumps(order))
    assert isinstance(back, tns.Order) and isinstance(back.items[0], tns.Item)
    assert (back.id, back.status, back.items[0].sku, back.ship_to.city, back.totals) == (
        9, 2, "s", "Bern", {"chf": 42})
    jorder = pickle.loads(pickle.dumps(jns.Order(id=3, ship_to=jns.Order_Address(city="Z"))))
    assert type(jorder) is jns.Order and jorder.ship_to.city == "Z"
    t = tns.Transfer(from_="a", to="b", in_=True)
    assert [f[0] for f in tns.Transfer.__proto_fields__] == ["from", "to", "in"]
    assert (t.from_, t.in_) == ("a", True)


# ----------------------------------------------------------- dual seam
def test_each_seam_sees_only_its_own_simulation():
    """Inside a JAX package simulation the port's seam is in real mode
    (no simulation of its own), and inside a port simulation the JAX
    package's is; each sees its own."""

    def probe(ms):
        async def main():
            return [t_dual.in_sim(), j_dual.in_sim(),
                    type(t_dual.make_notify()).__module__,
                    type(j_dual.make_notify()).__module__,
                    type(t_dual.rng()).__name__, type(j_dual.rng()).__name__]

        return ms.Runtime(seed=5).block_on(main())

    port, jax = probe(tms), probe(jms)
    assert port[:4] == [True, False, "madsim_tpu_torch.sync", "madsim_tpu.services._dual"]
    assert jax[:4] == [False, True, "madsim_tpu_torch.services._dual", "madsim_tpu.sync"]
    assert port[4] == jax[5] != "_StdRng" and port[5] == jax[4] == "_StdRng"
    assert not t_dual.in_sim() and not j_dual.in_sim()


# ------------------------------------------------------- real loopback
async def wait_bound(server, task) -> str:
    for _ in range(250):
        if server.local_addr is not None:
            return f"127.0.0.1:{server.local_addr[1]}"
        if task.done():
            task.result()
        await asyncio.sleep(0.02)
    raise TimeoutError("server never bound")


class Greeter:
    SERVICE_NAME = "helloworld.Greeter"

    async def say_hello(self, request):
        return {"message": f"Hello {request.message['name']}!"}

    async def lots_of_replies(self, request):
        for i in range(3):
            yield {"message": f"reply #{i}"}


# (server's grpc, server's etcd, client's grpc, client's etcd)
PAIRS = {
    "port": (t_grpc, t_etcd, t_grpc, t_etcd),
    "port-server-jax-client": (t_grpc, t_etcd, j_grpc, j_etcd),
    "jax-server-port-client": (j_grpc, j_etcd, t_grpc, t_etcd),
}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_greeter_over_real_tcp(pair):
    server_grpc, _se, client_grpc, _ce = PAIRS[pair]

    async def main():
        router = server_grpc.Server.builder().add_service(Greeter())
        task = asyncio.create_task(router.serve("127.0.0.1:0"))
        addr = await wait_bound(router, task)
        try:
            c = client_grpc.service_client(Greeter, await client_grpc.connect(addr))
            r = await asyncio.wait_for(c.say_hello({"name": "world"}), 10)
            stream = await asyncio.wait_for(c.lots_of_replies({"name": "x"}), 10)
            got = [item["message"] async for item in stream]
            return r["message"], got
        finally:
            task.cancel()

    assert asyncio.run(main()) == ("Hello world!", ["reply #0", "reply #1", "reply #2"])


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_etcd_over_real_tcp(pair):
    _sg, server_etcd, _cg, client_etcd = PAIRS[pair]

    async def main():
        server = server_etcd.SimServer()
        task = asyncio.create_task(server.serve("127.0.0.1:0"))
        addr = await wait_bound(server, task)
        try:
            c = await client_etcd.Client.connect([addr])
            r1 = await asyncio.wait_for(c.put("k1", "v1"), 10)
            r2 = await asyncio.wait_for(c.put("k1", "v2"), 10)
            kv = (await asyncio.wait_for(c.get("k1"), 10))["kvs"][0]
            t = (client_etcd.Txn()
                 .when([client_etcd.Compare.value("k1", "=", "v2")])
                 .and_then([client_etcd.TxnOp.put("k1", "v3")]))
            txn = await asyncio.wait_for(c.txn(t), 10)
            lease = await asyncio.wait_for(c.lease_client().grant(ttl=60), 10)
            await asyncio.wait_for(
                c.put("eph", "x", client_etcd.PutOptions(lease=lease["id"])), 10)
            ttl = await asyncio.wait_for(c.lease_client().time_to_live(lease["id"]), 10)
            obs = await client_etcd.Client.connect([addr])
            stream = await obs.election_client().observe("mayor")
            win = await asyncio.wait_for(
                c.election_client().campaign("mayor", "alice", lease["id"]), 10)
            first = await asyncio.wait_for(stream.message(), 10)
            await asyncio.wait_for(c.election_client().proclaim(win["key"], "alice2"), 10)
            second = await asyncio.wait_for(stream.message(), 10)
            stream.close()
            d = await asyncio.wait_for(
                c.delete("k", client_etcd.DeleteOptions(prefix=True)), 10)
            await c.close()
            await obs.close()
            return [r2["header_revision"] - r1["header_revision"], kv.value, kv.version,
                    txn["succeeded"], ttl["keys"], first["kv"].value, second["kv"].value,
                    d["deleted"]]
        finally:
            task.cancel()

    assert asyncio.run(main()) == [1, b"v2", 2, True, [b"eph"], b"alice", b"alice2", 1]


def test_kafka_over_real_tcp():
    """Produce, fetch and the consumer group over the std backend, the
    port on both ends (``tests/test_dual_mode.py``'s two Kafka cases)."""
    kafka = t_kafka

    async def main():
        broker = kafka.SimBroker()
        task = asyncio.create_task(broker.serve("127.0.0.1:0"))
        addr = await wait_bound(broker, task)
        try:
            cfg = kafka.ClientConfig().set("bootstrap.servers", addr)
            admin = await cfg.create(kafka.AdminClient)
            await asyncio.wait_for(admin.create_topics([kafka.NewTopic("t", 1),
                                                        kafka.NewTopic("jobs", 4)]), 10)
            producer = await cfg.create(kafka.FutureProducer)
            for i in range(5):
                await asyncio.wait_for(
                    producer.send(kafka.BaseRecord.to("t").set_payload(f"m{i}")), 10)
            for i in range(20):
                await producer.send(kafka.BaseRecord.to("jobs").set_payload(str(i)))
            consumer = await (kafka.ClientConfig().set("bootstrap.servers", addr)
                              .set("auto.offset.reset", "earliest")).create(kafka.BaseConsumer)
            tpl = kafka.TopicPartitionList()
            tpl.add_partition("t", 0)
            await consumer.assign(tpl)
            got, idle = [], 0
            while len(got) < 5 and idle < 50:
                msg = await asyncio.wait_for(consumer.poll(), 10)
                if msg is None:
                    idle += 1
                    await asyncio.sleep(0.05)
                else:
                    got.append(msg.payload)

            def ccfg():
                return (kafka.ClientConfig().set("bootstrap.servers", addr)
                        .set("group.id", "workers").set("auto.offset.reset", "earliest")
                        .set("session.timeout.ms", "30000")
                        .set("heartbeat.interval.ms", "100"))

            c1 = await ccfg().create(kafka.BaseConsumer)
            await c1.subscribe(["jobs"])
            c2 = await ccfg().create(kafka.BaseConsumer)
            await c2.subscribe(["jobs"])
            got1 = []
            for _ in range(30):
                m = await asyncio.wait_for(c1.poll(), 10)
                if m is None:
                    await asyncio.sleep(0.05)
                else:
                    got1.append(int(m.payload))
            a1, a2 = c1.assignment(), c2.assignment()
            await c1.commit()
            await c1.close()
            got2, idle = [], 0
            while idle < 30:
                m = await asyncio.wait_for(c2.poll(), 10)
                if m is None:
                    idle += 1
                    await asyncio.sleep(0.05)
                else:
                    idle = 0
                    got2.append(int(m.payload))
            final = c2.assignment()
            for cl in (admin, producer, consumer, c2):
                await cl.close()
            return got, a1, a2, final, set(got1) | set(got2)
        finally:
            task.cancel()

    got, a1, a2, final, seen = asyncio.run(main())
    assert sorted(got) == [b"m0", b"m1", b"m2", b"m3", b"m4"]
    assert len(a1) == 2 and len(a2) == 2 and not (set(a1) & set(a2))
    assert set(final) == {("jobs", p) for p in range(4)}
    assert seen == set(range(20))


# ------------------------------------------------------------- greeter
def _script(path, *args, seed=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    env.pop("MADSIM_TEST_SEED", None)
    if seed is not None:
        env["MADSIM_TEST_SEED"] = str(seed)
    out = subprocess.run([sys.executable, str(path), *args], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300, env=env)
    return out.stdout.splitlines()


@pytest.mark.parametrize("seed", SEEDS)
def test_greeter_copy_gives_the_examples_replies(seed):
    """The port's copy of ``examples/greeter.py`` prints, seed for seed,
    what the example prints: the four RPC shapes, UNAVAILABLE after the
    kill, the recovery after the restart, and the seed's end time."""
    want = _script(ROOT / "examples" / "greeter.py", "sim", seed=seed)
    got = _script(ROOT / "tests" / "_torch_greeter.py", "sim", seed=seed)
    assert got == want
    assert want[0] == "unary          : Hello world!"
    assert want[-3:-1] == ["after kill     : UNAVAILABLE", "after restart  : Hello phoenix!"]


def test_greeter_copy_over_real_tcp():
    """The same client and service over real loopback TCP: the four RPC
    shapes give the simulation's replies."""
    sim = _script(ROOT / "examples" / "greeter.py", "sim", seed=0)
    real = _script(ROOT / "tests" / "_torch_greeter.py", "real")
    assert real[:-1] == sim[:6]
    assert real[-1].startswith("real loopback TCP at 127.0.0.1:")
