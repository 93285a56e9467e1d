from .flash_attention import paged_attention, paged_attention_decode, paged_attention_prefill

__all__ = ["paged_attention", "paged_attention_decode", "paged_attention_prefill"]
