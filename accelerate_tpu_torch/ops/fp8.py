"""fp8 training with delayed scaling: the port of ``accelerate_tpu.ops.fp8``.

:func:`fp8_dot` is ``x @ w`` with both operands quantized to e4m3 from
scales that the amax histories of earlier steps give (delayed scaling),
and the backward's cotangent to ``recipe.grad_dtype`` (e5m2 under
``HYBRID``). The three products take f32 accumulation.

- On a CUDA tensor each product is ``torch._scaled_mm`` (cuBLASLt's fp8
  path on Hopper's tensor cores), with ``scale_a``/``scale_b`` the
  reciprocals of the quantization scales. ``_scaled_mm`` wants its first
  operand row-major and its second column-major and every dimension a
  multiple of 16: :func:`scaled_mm` makes the transposed copies in fp8,
  after quantizing, and pads with zeros (exact) where a dimension is not
  a multiple of 16. It never takes another route on the card.
  ``use_fast_accum=False``: cuBLASLt then promotes the tensor cores' fp8
  partial sums into f32 at intervals, as the JAX package's
  ``preferred_element_type=f32`` asks; the fast mode keeps them in the
  tensor cores' narrower accumulator over the whole depth.
- On a CPU tensor the product is the plain version: an f32 matmul of the
  upcast fp8 values divided by the product of the scales, which is what
  XLA computes on the CPU. The quantized operands and the scales are
  bitwise the JAX package's (the casts agree), so only the products carry
  a tolerance.

The meta (the three amax histories of one product site) is a
differentiable input whose "gradient" is its new value: the histories
rolled with this step's amax, as the JAX package returns them as the
cotangent of its ``custom_vjp``. :func:`make_fp8_optimizer` (and
``Accelerator(mixed_precision="fp8")``) install that value in place of an
update every micro-step. These gradients are values, never sums: a step
that sums gradients over ranks takes their element-wise MAX instead
(``max_r push(h, a_r) = push(h, max_r a_r)``, JAX's global amax).

A sharded step feeds each rank ``n`` times its rows' share of the global
loss's cotangent (the mean over the ``n`` batch ranks of the summed
gradients is the global gradient). :func:`cotangent_scale` tells the
backward that ``n``: it quantizes and records ``g / n``, JAX's cotangent,
and scales dx and dw back by ``n`` (exact for a power of two).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

__all__ = [
    "E4M3_MAX",
    "E5M2_MAX",
    "FP8Recipe",
    "META_KEY",
    "PRODUCTS",
    "cotangent_scale",
    "fp8_dense_apply",
    "fp8_dense_init",
    "fp8_dot",
    "fp8_meta_mask",
    "fp8_param_labels",
    "has_fp8_meta",
    "init_fp8_meta",
    "make_fp8_optimizer",
    "scaled_mm",
]

E4M3_MAX = 448.0
E5M2_MAX = 57344.0

META_KEY = "fp8_meta"  # param-tree key marking fp8 state leaves

_ALIGN = 16  # _scaled_mm's multiple for every dimension


@dataclass(frozen=True)
class FP8Recipe:
    """The JAX package's ``FP8Recipe``: ``margin``, the history length,
    ``amax_compute_algo`` (``"max"`` over the history or ``"most_recent"``)
    and ``fp8_format`` (``"HYBRID"``: e4m3 forward, e5m2 gradients;
    ``"E4M3"``: e4m3 for both)."""

    margin: int = 0
    amax_history_len: int = 16
    amax_compute_algo: str = "max"
    fp8_format: str = "HYBRID"

    def __post_init__(self):
        if self.amax_compute_algo not in ("max", "most_recent"):
            raise ValueError(f"unknown amax_compute_algo {self.amax_compute_algo!r}")
        if self.fp8_format not in ("HYBRID", "E4M3"):
            raise ValueError(f"unknown fp8_format {self.fp8_format!r}")

    @property
    def grad_dtype(self) -> torch.dtype:
        return torch.float8_e5m2 if self.fp8_format == "HYBRID" else torch.float8_e4m3fn

    @property
    def grad_max(self) -> float:
        return E5M2_MAX if self.fp8_format == "HYBRID" else E4M3_MAX


def init_fp8_meta(recipe: FP8Recipe = FP8Recipe(), device=None) -> dict:
    """Fresh meta of one product site: one f32 amax history per role, on
    ``device`` (the CUDA device when omitted)."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    h = recipe.amax_history_len
    return {name: torch.zeros(h, dtype=torch.float32, device=dev)
            for name in ("x_hist", "w_hist", "g_hist")}


def _scale_from_history(hist: torch.Tensor, fp8_max: float, recipe: FP8Recipe) -> torch.Tensor:
    amax = hist.max() if recipe.amax_compute_algo == "max" else hist[0]
    safe = torch.where(amax > 0, amax, fp8_max)
    # a true f32 division, as XLA's (a Python scalar over a tensor is a
    # reciprocal times the scalar in torch, an ulp off)
    return (safe.new_tensor(fp8_max) / safe) * (2.0 ** -recipe.margin)


def _quantize(x: torch.Tensor, scale: torch.Tensor, fp8_max: float,
              dtype: torch.dtype) -> torch.Tensor:
    return (x.float() * scale).clamp(-fp8_max, fp8_max).to(dtype)


def _push(hist: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    return torch.cat([amax.float().reshape(1), hist[:-1]])


def _amax(x: torch.Tensor) -> torch.Tensor:
    return x.detach().abs().amax()


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    r, c = x.shape
    if (r, c) == (rows, cols):
        return x
    out = x.new_zeros(rows, cols)
    out[:r, :c] = x
    return out


def _up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def scaled_mm(a: torch.Tensor, b_t: torch.Tensor, sa: torch.Tensor,
              sb: torch.Tensor) -> torch.Tensor:
    """``a @ b_t.T / (sa * sb)`` in f32 for fp8 ``a [M, K]`` and ``b_t [N,
    K]`` (both row-major) and f32 scalar scales. CUDA tensors:
    ``torch._scaled_mm`` with ``scale_a = 1/sa``, ``scale_b = 1/sb``, every
    dimension padded with zeros to a multiple of 16 where it is not (the
    padded rows and columns of the result are dropped), counted in
    ``scaled_mm.launches``. CPU tensors: the plain version."""
    if not a.is_cuda:
        return (a.float() @ b_t.float().T) / (sa * sb)
    M, K = a.shape
    N = b_t.shape[0]
    Mp, Kp, Np = _up(M), _up(K), _up(N)
    a_p = _pad_to(a.contiguous(), Mp, Kp)
    b_p = _pad_to(b_t.contiguous(), Np, Kp)
    out = torch._scaled_mm(a_p, b_p.T, scale_a=torch.reciprocal(sa).reshape(()),
                           scale_b=torch.reciprocal(sb).reshape(()), out_dtype=torch.float32,
                           use_fast_accum=False)
    scaled_mm.launches += 1
    return out[:M, :N] if (Mp, Np) != (M, N) else out


scaled_mm.launches = 0

#: fp8 products run by :func:`fp8_dot`, by pass (one a forward, two a
#: backward), on any device: with ``scaled_mm.launches`` a run shows that
#: every product of the path went through ``_scaled_mm``
PRODUCTS = {"forward": 0, "backward": 0}

_COTANGENT_SCALE = [1]


@contextlib.contextmanager
def cotangent_scale(n: int):
    """Within the block, :func:`fp8_dot` calls record that the cotangent
    reaching them is ``n`` times JAX's (see the module docstring)."""
    _COTANGENT_SCALE.append(int(n))
    try:
        yield
    finally:
        _COTANGENT_SCALE.pop()


class _FP8Dot(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, x_hist, w_hist, g_hist, recipe, n):
        sx = _scale_from_history(x_hist, E4M3_MAX, recipe)
        sw = _scale_from_history(w_hist, E4M3_MAX, recipe)
        qx = _quantize(x, sx, E4M3_MAX, torch.float8_e4m3fn).reshape(-1, x.shape[-1])
        qw = _quantize(w, sw, E4M3_MAX, torch.float8_e4m3fn)
        out = scaled_mm(qx, qw.T.contiguous(), sx, sw)
        PRODUCTS["forward"] += 1
        ctx.save_for_backward(qx, qw, sx, sw, x_hist, w_hist, g_hist, _amax(x), _amax(w))
        ctx.recipe, ctx.n = recipe, n
        ctx.x_shape, ctx.x_dtype, ctx.w_dtype = x.shape, x.dtype, w.dtype
        return out.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        qx, qw, sx, sw, x_hist, w_hist, g_hist, amax_x, amax_w = ctx.saved_tensors
        recipe, n = ctx.recipe, ctx.n
        if n != 1:
            g = g / g.new_full((), n)
        sg = _scale_from_history(g_hist, recipe.grad_max, recipe)
        qg = _quantize(g, sg, recipe.grad_max, recipe.grad_dtype).reshape(-1, g.shape[-1])
        # dx = g @ wᵀ, dw = xᵀ @ g; the transposed operands are fp8 copies
        dx = scaled_mm(qg, qw, sg, sw)
        dw = scaled_mm(qx.T.contiguous(), qg.T.contiguous(), sx, sg)
        PRODUCTS["backward"] += 2
        if n != 1:
            dx, dw = dx * n, dw * n
        return (dx.reshape(ctx.x_shape).to(ctx.x_dtype), dw.to(ctx.w_dtype),
                _push(x_hist, amax_x), _push(w_hist, amax_w), _push(g_hist, _amax(g)),
                None, None)


def fp8_dot(x: torch.Tensor, w: torch.Tensor, meta: dict,
            recipe: FP8Recipe = FP8Recipe()) -> torch.Tensor:
    """``x @ w`` in fp8 with delayed scaling. ``x [..., k]``, ``w [k, n]``,
    ``meta`` from :func:`init_fp8_meta`. The gradient of each meta leaf is
    its updated history (see the module docstring)."""
    return _FP8Dot.apply(x, w, meta["x_hist"], meta["w_hist"], meta["g_hist"], recipe,
                         _COTANGENT_SCALE[-1])


# ------------------------------------------------------------ dense helper --
def fp8_dense_init(in_dim: int, out_dim: int, generator: torch.Generator = None,
                   recipe: FP8Recipe = FP8Recipe(), scale=None, device=None) -> dict:
    """Params of a drop-in fp8 linear, ``{"kernel", "bias", META_KEY}``: the
    kernel ``N(0, scale²)`` (``1/√in_dim`` by default) drawn from
    ``generator`` (a fresh one seeded 0 when omitted), the bias zero. Its
    draws differ from JAX's; parity tests carry JAX's arrays through
    :func:`~..models.convert.params_from_numpy`."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    scale = scale if scale is not None else 1.0 / in_dim ** 0.5
    kernel = torch.randn(in_dim, out_dim, generator=generator, device=generator.device) * scale
    return {"kernel": kernel.to(dev), "bias": torch.zeros(out_dim, device=dev),
            META_KEY: init_fp8_meta(recipe, dev)}


def fp8_dense_apply(params: dict, x: torch.Tensor, recipe: FP8Recipe = FP8Recipe()):
    out = fp8_dot(x, params["kernel"], params[META_KEY], recipe)
    if "bias" in params:
        out = out + params["bias"]
    return out


# ----------------------------------------------------- optimizer partition --
def fp8_param_labels(params):
    """Label tree: ``"fp8_meta"`` under any ``META_KEY`` subtree,
    ``"default"`` elsewhere (the JAX package's labels of its optax
    partition)."""
    def walk(node, in_meta):
        if isinstance(node, dict):
            return {k: walk(v, in_meta or k == META_KEY) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, in_meta) for v in node)
        return "fp8_meta" if in_meta else "default"

    return walk(params, False)


def fp8_meta_mask(params) -> list:
    """One bool per tensor leaf of ``params`` (the port's leaf order, that
    of :func:`~..optimizer.param_leaves`): True under a ``META_KEY``."""
    out: list = []

    def walk(node, in_meta):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, in_meta or k == META_KEY)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, in_meta)
        elif isinstance(node, torch.Tensor):
            out.append(in_meta)

    walk(params, False)
    return out


def has_fp8_meta(params) -> bool:
    def walk(node):
        if isinstance(node, dict):
            return any(k == META_KEY or walk(v) for k, v in node.items())
        if isinstance(node, (list, tuple)):
            return any(walk(v) for v in node)
        return False

    return walk(params)


def make_fp8_optimizer(inner, params, accumulation_steps: int = 1):
    """The JAX package's partition in the port's form: an
    :class:`~..optimizer.AcceleratedOptimizer` bound to ``params`` whose
    torch optimizer (``inner``, a factory such as
    :func:`~..optimizer.adam`) owns the real params, while each meta leaf
    is replaced by its gradient (its new histories) on every micro-step.
    With ``accumulation_steps > 1`` the params update on boundaries only,
    on the window's mean gradient, and the meta still rolls every
    micro-step."""
    from ..optimizer import AcceleratedOptimizer

    opt = AcceleratedOptimizer(inner, accumulation_steps=accumulation_steps,
                               fp8_partition=True)
    opt.init(params)
    return opt
