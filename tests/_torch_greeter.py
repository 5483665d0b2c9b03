"""The port's copy of ``examples/greeter.py``: the Greeter service in
the simulation, with chaos, and over real loopback TCP.

    python tests/_torch_greeter.py sim     # seeded simulation with chaos
    MADSIM_TEST_SEED=7 python tests/_torch_greeter.py sim   # pick the seed
    python tests/_torch_greeter.py real    # the same client over loopback

The simulated run drives all four RPC shapes through a 2-node cluster,
kills the server mid-session, restarts it, and shows the client
recovering, as the example does. The real run serves the same class on
``127.0.0.1`` (port 0) with the real backend and drives the four shapes
from the same client code.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import asyncio  # noqa: E402

import madsim_tpu_torch as ms  # noqa: E402
from madsim_tpu_torch.services import grpc  # noqa: E402


class Greeter:
    SERVICE_NAME = "helloworld.Greeter"

    async def say_hello(self, request):
        return {"message": f"Hello {request.message['name']}!"}

    async def lots_of_replies(self, request):
        for i in range(3):
            await sleep(0.05)
            yield {"message": f"reply #{i} for {request.message['name']}"}

    async def record_hellos(self, stream):
        names = [msg["name"] async for msg in stream]
        return {"message": f"Hello {', '.join(names)}!"}

    async def chat(self, stream):
        async for msg in stream:
            yield {"message": f"ack:{msg['name']}"}


async def sleep(seconds):
    """Virtual time in the simulation, the wall clock outside it."""
    if ms.runtime.context.in_simulation():
        await ms.sleep(seconds)
    else:
        await asyncio.sleep(seconds)


async def four_shapes(c):
    r = await c.say_hello({"name": "world"})
    print("unary          :", r["message"])

    stream = await c.lots_of_replies({"name": "world"})
    async for msg in stream:
        print("server-stream  :", msg["message"])

    tx, reply = await c.record_hellos()
    for n in ("alice", "bob"):
        await tx.send({"name": n})
    await tx.finish()
    print("client-stream  :", (await reply)["message"])

    tx, stream = await c.chat()
    await tx.send({"name": "ping"})
    print("bidi           :", (await stream.message())["message"])
    await tx.finish()


@ms.main
async def sim_main():
    h = ms.Handle.current()

    async def serve():
        await grpc.Server.builder().add_service(Greeter()).serve("0.0.0.0:50051")

    server = h.create_node().name("server").ip("10.0.0.1").init(serve).build()
    client_node = h.create_node().name("client").ip("10.0.0.2").build()

    async def client():
        await ms.sleep(0.1)
        ch = await grpc.connect("10.0.0.1:50051")
        c = grpc.service_client(Greeter, ch)
        await four_shapes(c)

        # chaos: kill the server and watch the client observe UNAVAILABLE,
        # then restart and recover
        h.kill(server)
        try:
            await c.say_hello({"name": "ghost"})
        except grpc.Status as s:
            print("after kill     :", s.code.name)
        h.restart(server)
        await ms.sleep(0.2)
        r = await c.say_hello({"name": "phoenix"})
        print("after restart  :", r["message"])

    await client_node.spawn(client())
    print(f"seed {h.seed} complete at t={ms.now_ns() / 1e9:.3f}s simulated")


async def real_main():
    router = grpc.Server.builder().add_service(Greeter())
    task = asyncio.create_task(router.serve("127.0.0.1:0"))
    for _ in range(250):
        if router.local_addr is not None:
            break
        await asyncio.sleep(0.02)
    addr = f"127.0.0.1:{router.local_addr[1]}"
    try:
        ch = await grpc.connect(addr)
        await asyncio.wait_for(four_shapes(grpc.service_client(Greeter, ch)), 30)
        await ch.close()
    finally:
        task.cancel()
    print(f"real loopback TCP at {addr}")


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "sim"
    if mode == "sim":
        sim_main()
    elif mode == "real":
        asyncio.run(real_main())
    else:
        print("usage: _torch_greeter.py sim|real")
        sys.exit(1)
