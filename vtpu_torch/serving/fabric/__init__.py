"""The fabric (the port's copy of vtpu/serving/fabric): fleet members in
separate processes or hosts.

- :mod:`wire` — length-prefixed stdlib framing, protocol versioning,
  CRC32-chunked payload codec, typed ``TransportError`` hierarchy.
- :mod:`transport` — the ``Channel`` surface with two implementations:
  a deterministic in-proc loopback (fault seams: message loss, delay,
  partition, payload corruption — the tests' workhorse) and TCP.
- :mod:`host` — ``EngineHost``, serving one or more ``ServingEngine``s
  over a channel; runs in-proc or as a SIGKILL-able child process
  (``spawn_host``), whose engines run on the card unless its spec says
  ``"device": "cpu"``.
- :mod:`remote` — ``HostClient``/``RemoteEngine``, the proxy exposing
  exactly the member surface ``EngineFleet`` consumes, so local and
  remote members route/drain/rebalance/fail over through one code path.
"""

from vtpu_torch.serving.fabric.host import EngineHost, spawn_host
from vtpu_torch.serving.fabric.remote import (
    HostClient,
    RemoteEngine,
    connect_host,
)
from vtpu_torch.serving.fabric.transport import (
    Channel,
    ChecksumError,
    LoopbackChannel,
    ProtocolError,
    TcpChannel,
    TransportError,
    loopback_pair,
    tcp_connect,
)
from vtpu_torch.serving.fabric.wire import PROTO_VERSION

__all__ = [
    "PROTO_VERSION",
    "Channel", "LoopbackChannel", "TcpChannel",
    "TransportError", "ProtocolError", "ChecksumError",
    "loopback_pair", "tcp_connect",
    "EngineHost", "spawn_host",
    "HostClient", "RemoteEngine", "connect_host",
]
