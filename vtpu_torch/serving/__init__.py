"""Serving stack of the port (counterpart of vtpu/serving): the
continuous-batching engine over the dense transformer, on one device or
tensor-parallel over torch.distributed (``mesh=``), and over the MoE and
selective-SSM families on one device (``ServingEngine(model=...)`` with an
adapter from vtpu_torch.serving.adapters), with its failure domains
(deadlines, overload shedding, fault injection, the fetch watchdog) and, on
one device, disaggregated prefill/decode (``ServingConfig(disagg=
DisaggConfig(...))``, serving/disagg.py) and live migration between
engines with drain (``migrate``, ``ServingEngine.drain``,
serving/migrate.py), and the engine fleet (``EngineFleet``: supervision,
routing and failover, serving/fleet.py) with its content-addressed prefix
directory (serving/prefixdir.py), whose members may serve in another
process or on another host behind the fabric (``EngineHost``,
``RemoteEngine``, ``spawn_host``: serving/fabric)."""

from vtpu_torch.serving.adapters import TransformerSlotModel
from vtpu_torch.serving.disagg import DisaggConfig
from vtpu_torch.serving.engine import (
    BlockAllocator,
    Request,
    ServingConfig,
    ServingEngine,
    Status,
    Terminal,
    WaitQueue,
    batched_decode_step,
    prefill_into_slot,
    prefill_into_slots,
)
from vtpu_torch.serving.fabric import (
    EngineHost,
    HostClient,
    RemoteEngine,
    TransportError,
    connect_host,
    loopback_pair,
    spawn_host,
    tcp_connect,
)
from vtpu_torch.serving.faults import (
    SEAMS,
    EngineDeath,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    WorkerDeath,
)
from vtpu_torch.serving.fleet import (
    EngineFleet,
    FleetConfig,
    LeastPressureRoutePolicy,
    RoutePolicy,
    load_route_policy,
)
from vtpu_torch.serving.migrate import MigrationError, drain_engine, migrate
from vtpu_torch.serving.prefixdir import (
    PrefixDirectory,
    export_prefix,
    install_prefix,
    prefix_id,
)
from vtpu_torch.serving.shed import (
    EngineSignals,
    PriorityDeadlineShedPolicy,
    ShedPolicy,
    accepts_signals,
    load_shed_policy,
)

__all__ = [
    "BlockAllocator",
    "DisaggConfig",
    "EngineDeath",
    "EngineFleet",
    "EngineHost",
    "EngineSignals",
    "FaultInjected",
    "FaultPlan",
    "FaultSpec",
    "FleetConfig",
    "HostClient",
    "LeastPressureRoutePolicy",
    "MigrationError",
    "PrefixDirectory",
    "PriorityDeadlineShedPolicy",
    "RemoteEngine",
    "Request",
    "RoutePolicy",
    "SEAMS",
    "ServingConfig",
    "ServingEngine",
    "ShedPolicy",
    "Status",
    "Terminal",
    "TransformerSlotModel",
    "TransportError",
    "WaitQueue",
    "WorkerDeath",
    "accepts_signals",
    "batched_decode_step",
    "connect_host",
    "drain_engine",
    "export_prefix",
    "install_prefix",
    "load_route_policy",
    "load_shed_policy",
    "loopback_pair",
    "migrate",
    "prefill_into_slot",
    "prefill_into_slots",
    "prefix_id",
    "spawn_host",
    "tcp_connect",
]
