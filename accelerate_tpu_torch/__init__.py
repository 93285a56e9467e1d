"""PyTorch/CUDA port of ``accelerate_tpu``.

The JAX package beside this one is the reference; every module here keeps
the module name of its counterpart there, so ``accelerate_tpu_torch.serving.
engine`` ports ``accelerate_tpu.serving.engine``. This package imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of
``accelerate_tpu`` — and its entry points run on the CUDA device unless the
caller asks for ``device="cpu"``.

Ported so far:

- serving: the paged serving engine — the Llama decoder
  (``models.transformer``), the host-side block allocator and scheduler
  (``serving``), and two hand-written Hopper paged-attention kernels
  (``ops.flash_attention`` over ``csrc/paged_*.cu``); sampling from
  ``jax.random``'s exact threefry streams (``utils.random``,
  ``generation.sample_token_logits``), speculative decoding with a
  truncated-layer self-draft (``draft_config``/``draft_params``), static
  batching, the admission watermark, ``prefix_cache=False`` and resuming
  from ``generated`` tokens;
- training: BERT (``models.transformer``) through ``Accelerator.prepare``
  and ``prepare_train_loop`` (``accelerator``, ``optimizer``,
  ``data_loader``, ``state``), with the fused attention forward and
  backward kernels (``ops.fused_attention`` over
  ``csrc/fused_attention_*.cu``);
- Llama training: ``llama_forward`` with ``attention_impl``, packed
  ``segment_ids`` and per-segment positions, and ``llama_loss``
  (``models.transformer``), ``utils.packing``, and the blocked flash
  attention forward, dq and dk/dv kernels (``ops.flash_attention`` over
  ``csrc/flash_*.cu``) behind ``flash_attention`` and
  ``dot_product_attention(impl="flash")``;
- training-loop options: gradient accumulation (``optax.MultiSteps``'
  semantics in ``optimizer``), ``mixed_precision="fp16"`` with dynamic loss
  scaling (``GradScalerConfig``; the fused attention kernels in fp16 too),
  the optax schedules and ``AcceleratedScheduler`` (``scheduler``),
  ``DummyOptim``/``DummyScheduler``, ``has_aux``, ``compute_grad_norm``,
  ``accumulate``, ``no_sync``, ``gradient_fn`` and the eager clips;
- ``llama_forward(remat=...)`` with JAX's policies (``torch.utils.
  checkpoint`` per layer), ``optimizer.adafactor`` (optax's chain and
  dtypes), ``chain(clip_by_global_norm(...), tx)``, and bf16 params
  through ``prepare_train_loop``.
"""

from .accelerator import Accelerator
from .data_loader import DataLoader
from .optimizer import (
    constant_schedule,
    cosine_decay_schedule,
    linear_schedule,
    warmup_cosine_decay_schedule,
)
from .scheduler import AcceleratedScheduler
from .utils.dataclasses import (
    DummyOptim,
    DummyScheduler,
    GradientAccumulationPlugin,
    GradScalerConfig,
)
from .generation import sample_token_logits
from .models.transformer import (
    BertConfig,
    LlamaConfig,
    bert_forward,
    bert_loss,
    draft_config,
    draft_params,
    init_bert,
    init_llama,
    llama_forward,
    llama_loss,
)
from .serving.buckets import BucketLattice
from .serving.engine import ServingEngine, paged_forward
from .serving.scheduler import Request, RequestStatus
from .ops.flash_attention import flash_attention  # after serving: the two import each other

__all__ = [
    "AcceleratedScheduler",
    "Accelerator",
    "BertConfig",
    "BucketLattice",
    "DataLoader",
    "DummyOptim",
    "DummyScheduler",
    "GradScalerConfig",
    "GradientAccumulationPlugin",
    "LlamaConfig",
    "Request",
    "RequestStatus",
    "ServingEngine",
    "bert_forward",
    "bert_loss",
    "constant_schedule",
    "cosine_decay_schedule",
    "draft_config",
    "draft_params",
    "flash_attention",
    "init_bert",
    "init_llama",
    "linear_schedule",
    "llama_forward",
    "llama_loss",
    "paged_forward",
    "sample_token_logits",
    "warmup_cosine_decay_schedule",
]
