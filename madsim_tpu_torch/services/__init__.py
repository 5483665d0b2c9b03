"""Service-level simulators — the ecosystem shims of the reference.

  * :mod:`grpc`  — gRPC-style typed services over simulated connections
                   (parity: madsim-tonic, reference madsim-tonic/src/)
  * :mod:`etcd`  — etcd v3 KV/Txn/Lease/Election state machine
                   (parity: madsim-etcd-client, src/service.rs)
  * :mod:`kafka` — Kafka-style producer/consumer/admin over a SimBroker
                   (parity: madsim-rdkafka, src/sim/)

Each runs as ordinary user tasks inside the single-seed runtime, built on
``madsim_tpu_torch.net.Endpoint`` exactly as the reference shims are built on
its Endpoint (SURVEY.md §1 L3).
"""

from . import grpc  # noqa: F401
from . import etcd  # noqa: F401
from . import kafka  # noqa: F401
