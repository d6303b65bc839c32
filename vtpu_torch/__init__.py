"""vtpu_torch: the PyTorch/CUDA port of the vTPU data plane.

A package beside the JAX reference (``vtpu``) with the same structure and
names: ``ops`` (norms, rope, attention with the hand-written Hopper kernels),
``models`` (the dense transformer), ``serving`` (the continuous-batching
engine), ``parallel`` (tensor-parallel serving over torch.distributed). It
imports torch and numpy only, never jax or anything of ``vtpu``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

from vtpu_torch import models, obs, ops, parallel, serving  # noqa: F401

__all__ = ["models", "obs", "ops", "parallel", "serving"]
