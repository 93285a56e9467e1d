"""Blockwise int8 and NF4/fp4 weight quantization: the port of
``accelerate_tpu.ops.quantization``.

Weights stay on the device as int8 codes (or two 4-bit codebook indices
packed in a uint8) with one f32 scale a block, and every consumer sees
the dequantized tensor: a :class:`QuantizedArray` answers
``__torch_function__`` (and ``@``) with its dequantized value, as the JAX
package's ``__jax_array__`` does, so a forward written for plain tensors
(``x @ p["wq"]["kernel"]``) runs on quantized params unchanged. Each
layout, code and scale is the JAX package's, bit for bit: the absmax and
the divisions are f32 on both sides and both round half to even.

:func:`int8_dynamic_matmul` is the activation×weight int8 product: ``x``
quantized per row, a k-blocked weight (:func:`quantize_int8_matmul_weight`)
and exact int32 partial products per k-block, through ``torch._int_mm``
(cuBLASLt's int8 path) on a CUDA tensor, rows padded with zeros to the
multiple of 16 it takes, counted in ``int_mm.launches``; the plain int32
product on a CPU tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

__all__ = [
    "FP4_CODE",
    "NF4_CODE",
    "QuantizationConfig",
    "QuantizedArray",
    "dequantize_blockwise_4bit",
    "dequantize_blockwise_int8",
    "dequantize_params",
    "int8_block_partials",
    "int8_dynamic_matmul",
    "int_mm",
    "quantize",
    "quantize_blockwise_4bit",
    "quantize_blockwise_int8",
    "quantize_int8_matmul_weight",
    "quantize_params",
    "quantize_rows",
    "quantized_byte_size",
]

# NF4 codebook (QLoRA): 16 quantiles of N(0,1) normalized to [-1, 1].
NF4_CODE = np.asarray(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)


@dataclass
class QuantizationConfig:
    """The JAX package's ``QuantizationConfig``: 8-bit or 4-bit
    (``quant_type`` ``"nf4"`` or ``"fp4"``), the block size, the dtype a
    dequantized leaf comes back in (a torch dtype), the path substrings
    that are never quantized and the smallest leaf that is."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    quant_type: str = "nf4"
    block_size: int = 64
    compute_dtype: Any = torch.bfloat16
    skip_modules: Sequence[str] = field(default_factory=lambda: ("lm_head", "embed"))
    min_size: int = 4096

    def __post_init__(self):
        if self.load_in_8bit and self.load_in_4bit:
            raise ValueError("pick one of load_in_8bit / load_in_4bit")
        if not (self.load_in_8bit or self.load_in_4bit):
            raise ValueError("enable load_in_8bit or load_in_4bit")
        if self.load_in_4bit and self.quant_type not in ("nf4", "fp4"):
            raise ValueError(f"unknown 4-bit quant_type {self.quant_type!r}")

    @property
    def bits(self) -> int:
        return 8 if self.load_in_8bit else 4


# ----------------------------------------------------------------- int8 -----
def _lead(shape) -> int:
    """A leaf of two or more dims keeps its leading axis (blocks never
    cross a leading slice), so stacked ``[L, ...]`` leaves stay sliceable
    per layer; a 1-D leaf is one flat stream."""
    return shape[0] if len(shape) >= 2 else 1


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true f32 division on every device: a Python scalar
    divisor makes CUDA multiply by its reciprocal, an ulp away from XLA's
    quotient."""
    return x / x.new_full((), d)


def _blocks(arr: torch.Tensor, block_size: int) -> torch.Tensor:
    """``[lead, n_blocks, block_size]`` f32, each leading slice padded with
    zeros to a whole number of blocks."""
    flat = arr.reshape(_lead(arr.shape), -1)
    pad = (-flat.shape[1]) % block_size
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(flat.shape[0], -1, block_size).float()


def quantize_blockwise_int8(arr: torch.Tensor, block_size: int = 64):
    """Absmax int8 per block: ``(codes, scales)`` with ``scale =
    absmax/127`` and ``codes = round(x/scale)`` in ``[-127, 127]``; 1-D
    input gives flat codes, otherwise codes ``[d0, -1]``."""
    blocks = _blocks(arr, block_size)
    scales = _div(blocks.abs().amax(dim=2, keepdim=True), 127.0)
    codes = torch.round(blocks / torch.where(scales > 0, scales, 1.0))
    codes = codes.clamp(-127, 127).to(torch.int8)
    if arr.dim() < 2:
        return codes.reshape(-1), scales.reshape(-1)
    return codes.reshape(blocks.shape[0], -1), scales.reshape(blocks.shape[0], -1)


def dequantize_blockwise_int8(codes: torch.Tensor, scales: torch.Tensor, shape,
                              dtype=torch.bfloat16, block_size: int = 64) -> torch.Tensor:
    lead = _lead(shape)
    out = codes.reshape(lead, -1, block_size).float() * scales.reshape(lead, -1, 1)
    per_slice = int(np.prod(shape)) // lead
    return out.reshape(lead, -1)[:, :per_slice].reshape(shape).to(dtype)


# ------------------------------------------------------------------ 4-bit ----
# "fp4"-style: 16 evenly spaced levels in [-1, 1], the f32 values
# ``jnp.linspace(-1.0, 1.0, 16, dtype=float32)`` gives (numpy's and torch's
# linspace round 11 of them differently)
FP4_CODE = np.asarray(
    [
        -1.0, -0.8666666746139526, -0.7333333492279053, -0.5999999642372131,
        -0.46666666865348816, -0.333333283662796, -0.19999994337558746,
        -0.0666666105389595, 0.06666672229766846, 0.20000004768371582,
        0.3333333730697632, 0.46666672825813293, 0.6000001430511475,
        0.7333334684371948, 0.8666667938232422, 1.0,
    ],
    dtype=np.float32,
)


def _codebook(quant_type: str, device) -> torch.Tensor:
    return torch.from_numpy(NF4_CODE if quant_type == "nf4" else FP4_CODE).to(device)


def quantize_blockwise_4bit(arr: torch.Tensor, block_size: int = 64, quant_type: str = "nf4"):
    """Nearest codebook entry of ``x / absmax`` per block (the first on a
    tie, as ``argmin`` picks it), two indices packed in a uint8 (high
    nibble first) → ``(packed, scales)``. One leading slice at a time: the
    distance tensor is ``[n_blocks, block_size, 16]`` f32 of one slice,
    not of the whole leaf, and blocks never cross a slice."""
    blocks = _blocks(arr, block_size)
    code = _codebook(quant_type, arr.device)
    absmax = blocks.abs().amax(dim=2, keepdim=True)
    scales = torch.where(absmax > 0, absmax, 1.0)
    idx = torch.empty(blocks.shape, dtype=torch.uint8, device=arr.device)
    for s in range(blocks.shape[0]):
        normed = blocks[s] / scales[s]
        idx[s] = torch.argmin((normed[..., None] - code).abs(), dim=-1).to(torch.uint8)
    idx = idx.reshape(blocks.shape[0], -1)
    packed = (idx[:, 0::2] << 4) | idx[:, 1::2]
    if arr.dim() < 2:
        return packed.reshape(-1), scales.reshape(-1)
    return packed, scales.reshape(blocks.shape[0], -1)


def dequantize_blockwise_4bit(packed: torch.Tensor, scales: torch.Tensor, shape,
                              dtype=torch.bfloat16, block_size: int = 64,
                              quant_type: str = "nf4") -> torch.Tensor:
    code = _codebook(quant_type, packed.device)
    lead = _lead(shape)
    packed = packed.reshape(lead, -1)
    idx = torch.stack([packed >> 4, packed & 0xF], dim=2).reshape(lead, -1).long()
    vals = code[idx].reshape(lead, -1, block_size) * scales.reshape(lead, -1, 1)
    per_slice = int(np.prod(shape)) // lead
    return vals.reshape(lead, -1)[:, :per_slice].reshape(shape).to(dtype)


# --------------------------------------------------------- QuantizedArray ---
def _items(x) -> list:
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _items(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _items(v)]
    return [x]


def _dequantized(x, dtype):
    if isinstance(x, QuantizedArray):
        out = x.dequantize()
        return out if out.dtype == dtype else out.to(dtype)
    if isinstance(x, (list, tuple)):
        return type(x)(_dequantized(v, dtype) for v in x)
    if isinstance(x, dict):
        return {k: _dequantized(v, dtype) for k, v in x.items()}
    return x


def _promoted(items: list) -> torch.dtype:
    """The dtype JAX's promotion gives the floating operands (a quantized
    leaf counts as its dequantized dtype): an f32 activation times a bf16
    dequantized weight is f32, as ``x @ q`` is under ``__jax_array__``."""
    dtypes = [t.dtype for t in items
              if isinstance(t, QuantizedArray) or (isinstance(t, torch.Tensor)
                                                   and t.is_floating_point())]
    out = dtypes[0]
    for d in dtypes[1:]:
        out = torch.promote_types(out, d)
    return out


class QuantizedArray:
    """A quantized weight leaf: int8 (or packed uint8) ``codes`` and f32
    per-block ``scales``, with the dense ``shape``, the ``dtype`` it
    dequantizes to, ``bits``, ``block_size`` and ``quant_type``. Any torch
    function given one (``__torch_function__``, ``@`` either side) sees
    its dequantized tensor, cast up to the floating operands' promoted
    dtype as JAX promotes an array it gets from ``__jax_array__``.

    ``q[i]`` (an int) and ``q.unbind(0)`` are JAX's sliced-layer view: the
    codes and scales of leading slice ``i`` (1-D), with the stacked
    ``shape`` kept, as ``lax.scan`` slices the JAX package's children and
    leaves its static shape; :meth:`dequantize` gives that slice's dense
    ``shape[1:]``. ``q[a:b]`` keeps slices ``a..b`` of a stacked leaf."""

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor, shape, dtype, bits: int,
                 block_size: int, quant_type: str = "nf4"):
        self.codes = codes
        self.scales = scales
        self.shape = tuple(shape)
        self.dtype = dtype
        self.bits = bits
        self.block_size = block_size
        self.quant_type = quant_type

    def _with(self, codes, scales, shape=None) -> "QuantizedArray":
        return QuantizedArray(codes, scales, self.shape if shape is None else shape,
                              self.dtype, self.bits, self.block_size, self.quant_type)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def nbytes_quantized(self) -> int:
        return (self.codes.numel() * self.codes.element_size()
                + self.scales.numel() * self.scales.element_size())

    def _sliced_shape(self):
        """None for an intact leaf; the per-slice shape of a sliced view
        (a leaf of two or more dims stores 2-D codes, so 1-D codes mean
        one slice)."""
        if len(self.shape) >= 2 and self.codes.dim() == 1:
            return self.shape[1:]
        return None

    def dequantize(self, dtype=None) -> torch.Tensor:
        dtype = dtype or self.dtype
        if self.quant_type == "int8_kblock":
            return _dequantize_kblock(self, dtype)
        shape = self.shape
        sliced = self._sliced_shape()
        if sliced is not None:  # one slice's flat block stream
            shape = (int(np.prod(sliced)),)
        if self.bits == 8:
            out = dequantize_blockwise_int8(self.codes, self.scales, shape, dtype,
                                            self.block_size)
        else:
            out = dequantize_blockwise_4bit(self.codes, self.scales, shape, dtype,
                                            self.block_size, self.quant_type)
        return out.reshape(sliced) if sliced is not None else out

    def _stacked(self) -> None:
        if self.quant_type == "int8_kblock" or len(self.shape) < 2 or self.codes.dim() != 2:
            raise TypeError(f"{self!r} has no leading axis to slice")

    def __getitem__(self, index):
        if isinstance(index, int):
            self._stacked()
            return self._with(self.codes[index], self.scales[index])
        if isinstance(index, slice):
            self._stacked()
            codes = self.codes[index]
            return self._with(codes, self.scales[index], (codes.shape[0], *self.shape[1:]))
        return self.dequantize()[index]

    def unbind(self, dim: int = 0) -> tuple:
        if dim != 0:
            raise ValueError("a QuantizedArray unbinds along its leading axis only")
        self._stacked()
        return tuple(self[i] for i in range(self.codes.shape[0]))

    def to(self, device, non_blocking: bool = False) -> "QuantizedArray":
        """Codes and scales moved to ``device``."""
        return self._with(self.codes.to(device, non_blocking=non_blocking),
                          self.scales.to(device, non_blocking=non_blocking))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtype = _promoted(_items(args) + _items(kwargs))
        return func(*_dequantized(args, dtype), **_dequantized(kwargs, dtype))

    def __matmul__(self, other):
        return _dequantized(self, _promoted([self, other])) @ other

    def __rmatmul__(self, other):
        return other @ _dequantized(self, _promoted([other, self]))

    def __repr__(self) -> str:
        return (f"QuantizedArray(shape={self.shape}, bits={self.bits}, "
                f"type={self.quant_type if self.bits == 4 else 'int8'}, "
                f"block={self.block_size})")


def quantize(arr: torch.Tensor, config: QuantizationConfig) -> QuantizedArray:
    if config.load_in_8bit:
        codes, scales = quantize_blockwise_int8(arr, config.block_size)
        return QuantizedArray(codes, scales, arr.shape, config.compute_dtype, 8,
                              config.block_size)
    packed, scales = quantize_blockwise_4bit(arr, config.block_size, config.quant_type)
    return QuantizedArray(packed, scales, arr.shape, config.compute_dtype, 4,
                          config.block_size, config.quant_type)


def quantize_params(params, config: QuantizationConfig):
    """Every floating leaf of two or more dims and at least ``min_size``
    elements, whose '/'-joined path holds none of ``skip_modules``, as a
    :class:`QuantizedArray`; other leaves (``None`` too) pass through, in
    the same containers. Raises when nothing was quantized."""
    counter = [0]

    def walk(node, path):
        if isinstance(node, dict):
            return type(node)((k, walk(v, f"{path}/{k}" if path else str(k)))
                              for k, v in node.items())
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, f"{path}/{i}" if path else str(i))
                              for i, v in enumerate(node))
        if not isinstance(node, torch.Tensor):
            return node
        skip = any(s in path for s in config.skip_modules)
        if (skip or not node.is_floating_point() or node.dim() < 2
                or node.numel() < config.min_size):
            return node
        counter[0] += 1
        return quantize(node.detach(), config)

    out = walk(params, "")
    if counter[0] == 0:
        raise ValueError("nothing was quantized — check skip_modules/min_size")
    return out


def dequantize_params(params, dtype=None):
    """Every :class:`QuantizedArray` leaf back to a dense tensor."""
    if isinstance(params, QuantizedArray):
        return params.dequantize(dtype)
    if isinstance(params, dict):
        return type(params)((k, dequantize_params(v, dtype)) for k, v in params.items())
    if isinstance(params, (list, tuple)):
        return type(params)(dequantize_params(v, dtype) for v in params)
    return params


def quantized_byte_size(params) -> int:
    """Bytes of the tree with quantized leaves at their stored size."""
    if isinstance(params, QuantizedArray):
        return params.nbytes_quantized
    if isinstance(params, dict):
        return sum(quantized_byte_size(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(quantized_byte_size(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if params is None:
        return 0
    return int(np.asarray(params).nbytes)


# ------------------------------------------------------- int8 × int8 matmul --
def quantize_int8_matmul_weight(w: torch.Tensor, block_size: int = 128) -> QuantizedArray:
    """A 2-D ``[k, n]`` weight in the k-blocked int8 layout: one scale per
    (k-block, column), so the contraction runs in int8 with exact int32
    sums and a rescale per block."""
    if w.dim() != 2:
        raise ValueError("k-blocked int8 layout is for 2D weights")
    k, n = w.shape
    pad = (-k) % block_size
    if pad:
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    nblk = w.shape[0] // block_size
    blocks = w.reshape(nblk, block_size, n).float()
    scales = _div(blocks.abs().amax(dim=1, keepdim=True), 127.0)
    codes = torch.round(blocks / torch.where(scales > 0, scales, 1.0)).clamp(-127, 127)
    return QuantizedArray(codes.to(torch.int8), scales.reshape(nblk, n), (k, n), torch.bfloat16,
                          8, block_size, quant_type="int8_kblock")


def _dequantize_kblock(q: QuantizedArray, dtype) -> torch.Tensor:
    k, n = q.shape
    vals = q.codes.float() * q.scales[:, None, :]
    return vals.reshape(-1, n)[:k].reshape(k, n).to(dtype)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for int8 ``a [M, K]``, ``b [K, N]``, exact in int32. CUDA
    tensors: ``torch._int_mm`` (rows padded with zeros to a multiple of
    16, above 16; K and N must be multiples of 8, else it raises), counted
    in ``int_mm.launches``. CPU tensors: the plain int32 product."""
    if not a.is_cuda:
        return a.int() @ b.int()
    M, K = a.shape
    N = b.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f"_int_mm takes K and N in multiples of 8, got K={K}, N={N}")
    Mp = max(-(-M // 16) * 16, 32)
    a_p = a if Mp == M else torch.nn.functional.pad(a, (0, 0, 0, Mp - M))
    out = torch._int_mm(a_p.contiguous(), b.contiguous())
    int_mm.launches += 1
    return out[:M] if Mp != M else out


int_mm.launches = 0


def quantize_rows(x: torch.Tensor, w_q: QuantizedArray):
    """``(x_blocks, x_scale)``: ``x`` (``[..., k]``) absmax-quantized per row
    to int8 (scale ``absmax/127``), zero-padded to ``w_q``'s k-blocks and
    shaped ``[rows, n_blocks, block_size]``."""
    k = w_q.shape[0]
    x2 = x.reshape(-1, x.shape[-1]).float()
    pad = (-k) % w_q.block_size
    if pad:
        x2 = torch.nn.functional.pad(x2, (0, pad))
    x_absmax = x2.abs().amax(dim=1, keepdim=True)
    x_scale = torch.where(x_absmax > 0, _div(x_absmax, 127.0), 1.0)
    x_q = torch.round(x2 / x_scale).clamp(-127, 127).to(torch.int8)
    return x_q.reshape(x_q.shape[0], w_q.codes.shape[0], w_q.block_size), x_scale


def int8_block_partials(x: torch.Tensor, w_q: QuantizedArray):
    """``(partials, x_scale)``: the int32 products of ``x``'s quantized rows
    (:func:`quantize_rows`) with each k-block of ``w_q``, ``[n_blocks,
    rows, n]``."""
    xb, x_scale = quantize_rows(x, w_q)
    partials = torch.stack([int_mm(xb[:, b].contiguous(), w_q.codes[b])
                            for b in range(xb.shape[1])])
    return partials, x_scale


def int8_dynamic_matmul(x: torch.Tensor, w_q: QuantizedArray,
                        preferred_dtype=torch.bfloat16) -> torch.Tensor:
    """Activation-dynamic int8×int8 product with exact int32 block sums
    (:func:`int8_block_partials`), each rescaled by ``x_scale ⊗ w_scale``
    and summed in f32. A weight not in the k-blocked layout is
    dequantized and multiplied, as in the JAX package."""
    if getattr(w_q, "quant_type", None) != "int8_kblock":
        return x @ w_q
    n = w_q.shape[1]
    partials, x_scale = int8_block_partials(x, w_q)
    out = (partials.float() * w_q.scales[:, None, :]).sum(dim=0) * x_scale
    return out.reshape(*x.shape[:-1], n).to(preferred_dtype)
