"""ResNet family in PyTorch: the port of ``accelerate_tpu.models.resnet``.

Params keep the JAX layout — HWIO conv kernels ``[kh, kw, cin, cout]``,
each stage a list of block dicts under ``stage_<i>`` — so weights made by
the JAX initializer load unchanged through :mod:`.convert`. Images are
NHWC ``[B, H, W, 3]`` at the API, as in JAX; inside, the activations are
NCHW-shaped tensors in ``torch.channels_last`` memory (the same bytes as
NHWC, cuDNN's NHWC convolution path), and each kernel is permuted HWIO →
OIHW (channels-last) once per call.

The arithmetic follows the JAX package's:

- ``"SAME"`` padding is asymmetric, as XLA's: the total pad of a side of
  length ``n`` is ``max((ceil(n/s) - 1)·s + k - n, 0)``, the low side
  gets ``total // 2`` and the high side the rest (the 7×7/2 stem at 192
  pads 2 and 3; a 3×3/2 conv or max-pool on an even side 0 and 1). Convs
  pad with zeros, the max-pool with ``-inf`` (``reduce_window``'s init);
- GroupNorm: f32 statistics over (H, W, the group's channels), population
  variance, ``rsqrt(var + 1e-5)``, the normalised value cast to the
  activation dtype, then ``* scale + bias`` in the param dtype;
- the loss takes its log-softmax in f32.

The convolutions are PyTorch's (cuDNN): the JAX package computes them in
XLA, outside any Pallas kernel. On the card an f32 convolution follows
``torch.backends.cudnn.allow_tf32``, which PyTorch sets True by default:
f32 convolutions then run on TF32 tensor cores (10-bit mantissa inputs,
f32 accumulation). The port leaves that flag to the caller, as it leaves
``torch.backends.cuda.matmul.allow_tf32``; ``chip_smoke.py`` turns both off
so that its f32 checks compare f32 arithmetic with f32 arithmetic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

__all__ = ["ResNetConfig", "init_resnet", "resnet_forward", "resnet_loss", "resnet_shard_rules"]


@dataclass(frozen=True)
class ResNetConfig:
    """Same fields and defaults as the JAX package's ``ResNetConfig``."""

    block_sizes: tuple = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    num_classes: int = 1000
    groups: int = 32  # GroupNorm groups

    @classmethod
    def resnet50(cls, num_classes: int = 1000) -> "ResNetConfig":
        return cls(num_classes=num_classes)

    @classmethod
    def resnet18_ish(cls, num_classes: int = 10) -> "ResNetConfig":
        return cls(block_sizes=(2, 2, 2, 2), num_classes=num_classes)

    @classmethod
    def tiny(cls, num_classes: int = 4) -> "ResNetConfig":
        return cls(block_sizes=(1, 1), width=16, num_classes=num_classes, groups=4)


def init_resnet(config: ResNetConfig, generator: Optional[torch.Generator] = None,
                device=None, dtype: torch.dtype = torch.float32) -> dict:
    """Params with the JAX ``init_resnet`` tree and scales: conv kernels
    ``N(0, 2/fan_in)`` in HWIO, ``fc`` ``N(0, 0.01^2)``, norm scales one and
    biases zero. Draws come from ``generator`` (a fresh one seeded 0 on the
    target device when omitted), so they differ from JAX's threefry draws."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape, scale):
        w = torch.randn(*shape, generator=generator, device=generator.device)
        return (w * scale).to(device=dev, dtype=dtype)

    def conv(kh, kw, cin, cout):
        return {"kernel": normal(kh, kw, cin, cout, scale=math.sqrt(2.0 / (kh * kw * cin)))}

    def norm(c):
        return {"scale": torch.ones(c, device=dev, dtype=dtype),
                "bias": torch.zeros(c, device=dev, dtype=dtype)}

    w = config.width
    params: dict = {"stem": {"conv": conv(7, 7, 3, w), "norm": norm(w)}}
    cin = w
    for stage_idx, n_blocks in enumerate(config.block_sizes):
        cmid = w * (2 ** stage_idx)
        cout = cmid * 4
        stage = []
        for block_idx in range(n_blocks):
            block = {
                "conv1": conv(1, 1, cin, cmid), "norm1": norm(cmid),
                "conv2": conv(3, 3, cmid, cmid), "norm2": norm(cmid),
                "conv3": conv(1, 1, cmid, cout), "norm3": norm(cout),
            }
            if block_idx == 0 and cin != cout:
                block["downsample"] = {"conv": conv(1, 1, cin, cout), "norm": norm(cout)}
            stage.append(block)
            cin = cout
        params[f"stage_{stage_idx}"] = stage
    params["fc"] = {"kernel": normal(cin, config.num_classes, scale=0.01),
                    "bias": torch.zeros(config.num_classes, device=dev, dtype=dtype)}
    return params


def same_pads(n: int, k: int, s: int) -> "tuple[int, int]":
    """XLA's ``"SAME"`` padding of one side of length ``n`` for a window
    ``k`` at stride ``s``: ``(low, high)``, the high side taking the odd
    element."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``x`` NCHW (channels-last memory) by an HWIO ``kernel`` at ``stride``
    with ``"SAME"`` padding. Symmetric pads narrower than the input go to
    ``conv2d`` itself; the others are padded with zeros first (torch 2.13's
    CPU bf16 backward at stride 2 leaves the weight gradient's border taps
    unwritten when the pad is as wide as the input, e.g. a 1×1 input)."""
    kh, kw = kernel.shape[:2]
    weight = kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    (ht, hb), (wl, wr) = (same_pads(x.shape[2], kh, stride), same_pads(x.shape[3], kw, stride))
    if ht == hb and wl == wr and ht < x.shape[2] and wl < x.shape[3]:
        return F.conv2d(x, weight, stride=stride, padding=(ht, wl))
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), weight, stride=stride)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3×3 max-pool at stride 2 with ``"SAME"`` padding of ``-inf``."""
    (ht, hb), (wl, wr) = same_pads(x.shape[2], 3, 2), same_pads(x.shape[3], 3, 2)
    return F.max_pool2d(F.pad(x, (wl, wr, ht, hb), value=float("-inf")), 3, 2)


def _group_norm(x: torch.Tensor, p: dict, groups: int) -> torch.Tensor:
    """GroupNorm over NCHW ``x`` in the JAX package's rounding order. The
    group count is ``min(groups, C)``, lowered until it divides ``C``."""
    B, C, H, W = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    xf = x.float().reshape(B, g, C // g, H, W)
    var, mean = torch.var_mean(xf, dim=(2, 3, 4), unbiased=False, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + 1e-5)).reshape(B, C, H, W).to(x.dtype)
    return y * p["scale"][:, None, None] + p["bias"][:, None, None]


def resnet_forward(params: dict, x, config: ResNetConfig) -> torch.Tensor:
    """``x`` ``[B, H, W, 3]`` (NHWC; a host array goes to the params'
    device) → logits ``[B, num_classes]``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    x = x.to(params["fc"]["kernel"].device).permute(0, 3, 1, 2)  # NHWC bytes, NCHW shape
    h = _conv(x, params["stem"]["conv"]["kernel"], stride=2)
    h = torch.relu(_group_norm(h, params["stem"]["norm"], config.groups))
    h = _max_pool(h)
    for stage_idx in range(len(config.block_sizes)):
        for block_idx, block in enumerate(params[f"stage_{stage_idx}"]):
            stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
            shortcut = h
            out = torch.relu(_group_norm(_conv(h, block["conv1"]["kernel"]), block["norm1"],
                                         config.groups))
            out = torch.relu(_group_norm(_conv(out, block["conv2"]["kernel"], stride),
                                         block["norm2"], config.groups))
            out = _group_norm(_conv(out, block["conv3"]["kernel"]), block["norm3"], config.groups)
            if "downsample" in block:
                shortcut = _group_norm(_conv(h, block["downsample"]["conv"]["kernel"], stride),
                                       block["downsample"]["norm"], config.groups)
            elif stride != 1:  # the first block of a stage always downsamples
                shortcut = shortcut[:, :, ::stride, ::stride]
            h = torch.relu(out + shortcut)
    h = h.mean(dim=(2, 3))
    return h @ params["fc"]["kernel"] + params["fc"]["bias"]


def resnet_loss(params: dict, batch: dict, config: ResNetConfig) -> torch.Tensor:
    """Mean cross-entropy of :func:`resnet_forward` on ``batch["pixels"]``
    against ``batch["labels"]``, log-softmax in f32."""
    logits = resnet_forward(params, batch["pixels"], config)
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    return -logp.gather(-1, labels[:, None]).mean()


def resnet_shard_rules():
    """The JAX package's FSDP/TP rules: conv kernels (HWIO) shard the
    output-channel dim over ``tp``, the classifier its classes."""
    from ..parallel.sharding import ShardingRules

    return ShardingRules([
        (r".*conv.*/kernel", (None, None, None, "tp")),
        (r".*fc/kernel", (None, "tp")),
    ])
