"""PyTorch/CUDA port of ``accelerate_tpu``.

The JAX package beside this one is the reference; every module here keeps
the module name of its counterpart there, so ``accelerate_tpu_torch.serving.
engine`` ports ``accelerate_tpu.serving.engine``. This package imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of
``accelerate_tpu`` — and its entry points run on the CUDA device unless the
caller asks for ``device="cpu"``.

The ported slice so far is the paged serving engine: the Llama decoder
(``models.transformer``), the host-side block allocator and scheduler
(``serving``), and the two hand-written Hopper paged-attention kernels
(``ops.flash_attention`` over ``csrc/*.cu``).
"""

from .models.transformer import LlamaConfig, init_llama, llama_forward
from .serving.buckets import BucketLattice
from .serving.engine import ServingEngine, paged_forward
from .serving.scheduler import Request, RequestStatus

__all__ = [
    "BucketLattice",
    "LlamaConfig",
    "Request",
    "RequestStatus",
    "ServingEngine",
    "init_llama",
    "llama_forward",
    "paged_forward",
]
