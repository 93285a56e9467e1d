"""Quantized model loading: the port of ``accelerate_tpu.utils.quantization``
(the reference's ``utils/bnb.py``), over :mod:`..ops.quantization`.

A checkpoint streams into the param tree through
:func:`~.modeling.load_checkpoint_in_params`, then every matching leaf is
quantized; skip-listed leaves (the head and the embeddings) stay dense.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

from ..ops.quantization import (
    QuantizationConfig,
    QuantizedArray,
    dequantize_params,
    quantize_params,
    quantized_byte_size,
)

__all__ = [
    "QuantizationConfig",
    "QuantizedArray",
    "dequantize_params",
    "load_and_quantize_model",
    "quantize_params",
    "quantized_byte_size",
]


def load_and_quantize_model(params_or_template, quantization_config: QuantizationConfig,
                            checkpoint: Optional[str] = None,
                            device_map: Optional[Mapping[str, Any]] = None,
                            offload_folder: Optional[str] = None, execution_device=None):
    """Load (when ``checkpoint`` is given) and quantize a param tree.
    ``params_or_template`` is the params themselves, or a tree whose paths
    name the checkpoint's tensors (``abstract_params`` gives one) when a
    ``checkpoint`` is read; ``device_map`` and ``offload_folder`` place the
    loaded leaves as :func:`~.modeling.load_checkpoint_in_params` does, a
    leaf spilled to disk arriving as ``None``. Always returns
    ``(quantized_params, offload_index)``; the index is ``{}`` unless a leaf
    went to disk."""
    if checkpoint is not None:
        from .modeling import load_checkpoint_in_params

        params, offload_index = load_checkpoint_in_params(
            params_or_template, checkpoint, device_map=device_map,
            offload_folder=offload_folder, execution_device=execution_device)
    else:
        params, offload_index = params_or_template, {}
    return quantize_params(params, quantization_config), offload_index or {}
