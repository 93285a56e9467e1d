"""Precision settings: the port of the precision part of
``accelerate_tpu.utils.dataclasses``.

The policy casts at well-defined boundaries, as the JAX package does,
rather than through ``torch.autocast``: under bf16 the whole param tree is
cast to bf16 once per step, and the model code alone decides where f32 is
used (norm statistics, logits, softmax). Autocast would instead pick a
dtype per operator from its own lists.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Optional, Union

import torch

__all__ = ["MixedPrecisionPolicy", "PrecisionType"]


class PrecisionType(str, Enum):
    """Mixed-precision modes (the JAX package's ``PrecisionType``)."""

    NO = "no"
    FP16 = "fp16"
    BF16 = "bf16"
    FP8 = "fp8"

    def __str__(self) -> str:
        return self.value


def _map_floats(tree, fn):
    """``fn`` on every floating tensor leaf of a nested dict/list/tuple;
    integer leaves and non-tensors pass through."""
    if isinstance(tree, dict):
        return type(tree)((k, _map_floats(v, fn)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_floats(v, fn) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return fn(tree)
    return tree


@dataclass(frozen=True)
class MixedPrecisionPolicy:
    """dtype policy for params / compute / output; ``None`` leaves a dtype
    untouched."""

    param_dtype: Optional[torch.dtype] = None
    compute_dtype: Optional[torch.dtype] = None
    output_dtype: Optional[torch.dtype] = None

    @classmethod
    def from_precision(cls, precision: Union[str, PrecisionType]) -> "MixedPrecisionPolicy":
        precision = PrecisionType(str(precision))
        if precision == PrecisionType.NO:
            return cls(None, None, None)
        if precision == PrecisionType.BF16:
            return cls(torch.float32, torch.bfloat16, torch.float32)
        if precision == PrecisionType.FP16:
            return cls(torch.float32, torch.float16, torch.float32)
        # fp8 applies per matmul; activations stay bf16
        return cls(torch.float32, torch.bfloat16, torch.float32)

    @staticmethod
    def _cast(tree, dtype):
        if dtype is None:
            return tree
        return _map_floats(tree, lambda t: t.to(dtype))

    def cast_to_compute(self, tree):
        """Floating leaves to the compute dtype. On tensors that require
        grad this is an autograd op: gradients flow back through it to the
        param dtype, which is :meth:`cast_to_param` of the gradients."""
        return self._cast(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return self._cast(tree, self.param_dtype)
