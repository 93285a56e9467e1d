"""Attention and the kernels' wrappers: the names the JAX package's
``accelerate_tpu.ops`` exports. ``flash_attention`` and
``fused_attention`` here are the functions, as there, so the attribute
hides the module of the same name: reach the module with
``importlib.import_module("accelerate_tpu_torch.ops.flash_attention")`` or
``from accelerate_tpu_torch.ops.flash_attention import ...``."""

from .attention import dot_product_attention, make_padding_mask, segment_mask
from .flash_attention import (
    flash_attention,
    paged_attention,
    paged_attention_decode,
    paged_attention_prefill,
)
from .fused_attention import fused_attention

__all__ = ["dot_product_attention", "flash_attention", "fused_attention", "make_padding_mask",
           "paged_attention", "paged_attention_decode", "paged_attention_prefill",
           "segment_mask"]
