"""vtpu_torch: the PyTorch/CUDA port of the vTPU data plane.

A package beside the JAX reference (``vtpu``) with the same structure and
names: ``ops`` (norms, rope, attention with the hand-written Hopper kernels),
``models`` (the dense transformer, the MoE and the selective SSM, with
their losses), ``serving`` (the continuous-batching engine), ``parallel``
(tensor-parallel serving and the training toolkit over
torch.distributed). It imports torch and numpy only, never jax or
anything of ``vtpu``. Entry points run on the CUDA device unless the
caller passes ``device="cpu"``.
"""

# parallel before models: models import parallel.collectives, and
# parallel's training modules import models
from vtpu_torch import parallel  # noqa: F401, I001
from vtpu_torch import models, obs, ops, serving  # noqa: F401

__all__ = ["models", "obs", "ops", "parallel", "serving"]
