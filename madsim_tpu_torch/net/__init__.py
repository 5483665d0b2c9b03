"""Simulated network stack (reference: madsim/src/sim/net/)."""

from ..runtime.runtime import DEFAULT_SIMULATORS
from .addr import SocketAddr, lookup_host, parse_addr
from .endpoint import Endpoint, PipeReceiver, PipeSender
from .netsim import NetSim
from .network import Network, Stat
from .rpc import add_rpc_handler, add_rpc_handler_with_data, call, call_with_data, rpc_id
# NOTE: the @rpc decorator is deliberately NOT re-exported here — it
# would shadow the `net.rpc` submodule. Import it from the service
# module: `from madsim_tpu_torch.net.service import rpc, service`.
from .service import service
from .tcp import TcpListener, TcpStream
from .udp import UdpSocket
from .unix import UnixDatagram, UnixListener, UnixStream

if NetSim not in DEFAULT_SIMULATORS:
    DEFAULT_SIMULATORS.append(NetSim)

__all__ = [
    "Endpoint",
    "NetSim",
    "TcpListener",
    "TcpStream",
    "UdpSocket",
    "UnixDatagram",
    "UnixListener",
    "UnixStream",
    "Network",
    "PipeReceiver",
    "PipeSender",
    "SocketAddr",
    "Stat",
    "add_rpc_handler",
    "add_rpc_handler_with_data",
    "call",
    "call_with_data",
    "lookup_host",
    "parse_addr",
    "rpc_id",
]
