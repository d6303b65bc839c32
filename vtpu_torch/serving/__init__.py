"""Serving stack of the port (counterpart of vtpu/serving), first slice:
the synchronous continuous-batching engine over the dense transformer."""

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
