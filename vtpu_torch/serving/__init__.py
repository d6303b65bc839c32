"""Serving stack of the port (counterpart of vtpu/serving): the synchronous
continuous-batching engine over the dense transformer, on one device or
tensor-parallel over torch.distributed (``mesh=``)."""

from vtpu_torch.serving.adapters import TransformerSlotModel
from vtpu_torch.serving.engine import (
    BlockAllocator,
    Request,
    ServingConfig,
    ServingEngine,
    Status,
    Terminal,
    WaitQueue,
)

__all__ = [
    "BlockAllocator",
    "Request",
    "ServingConfig",
    "ServingEngine",
    "Status",
    "Terminal",
    "TransformerSlotModel",
    "WaitQueue",
]
