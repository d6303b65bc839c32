"""Serving stack of the port (counterpart of vtpu/serving): the
continuous-batching engine over the dense transformer, on one device or
tensor-parallel over torch.distributed (``mesh=``), and over the MoE and
selective-SSM families on one device (``ServingEngine(model=...)`` with an
adapter from vtpu_torch.serving.adapters), with its failure domains
(deadlines, overload shedding, fault injection, the fetch watchdog) and, on
one device, disaggregated prefill/decode (``ServingConfig(disagg=
DisaggConfig(...))``, serving/disagg.py)."""

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
from vtpu_torch.serving.faults import (
    SEAMS,
    EngineDeath,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    WorkerDeath,
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
    "EngineSignals",
    "FaultInjected",
    "FaultPlan",
    "FaultSpec",
    "PriorityDeadlineShedPolicy",
    "Request",
    "SEAMS",
    "ServingConfig",
    "ServingEngine",
    "ShedPolicy",
    "Status",
    "Terminal",
    "TransformerSlotModel",
    "WaitQueue",
    "WorkerDeath",
    "accepts_signals",
    "batched_decode_step",
    "load_shed_policy",
    "prefill_into_slot",
    "prefill_into_slots",
]
