"""Counter-based random streams: the threefry-2x32 keys and bits that
``jax.random`` draws from (``jax._src.prng``, ``jax._src.random``), so that
the port samples the same tokens as the JAX package from the same seed.

JAX's default, ``jax_threefry_partitionable=True``, makes every draw a pure
function of a key and a flat counter:

- ``PRNGKey(s)`` is ``[0, s mod 2**32]`` (32-bit seeds);
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
- ``bits(key, (..., n))`` is ``x0 ^ x1`` of ``threefry2x32(key, (0, i))``
  over the flat counter ``i = 0 .. n-1``;
- ``uniform`` puts the top 23 bits into the mantissa of a float in [1, 2)
  and subtracts 1; ``gumbel`` (``mode="low"``) is ``-log(-log(u))`` with u
  uniform in [tiny, 1).

torch's uint32 support is partial on both devices, so a uint32 word here is
an int64 tensor holding a value in [0, 2**32), masked after every add and
shift. Every function is batched over rows: ``keys [B, 2]``, and a counter
``arange(n)`` shared by every row. These are plain tensor ops: the JAX
package draws its bits in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

import random
from typing import Iterable

import numpy as np
import torch

__all__ = ["capture_rng_states", "fold_in", "get_rng_key", "gumbel", "prng_key", "random_bits",
           "restore_rng_states", "set_global_key", "synchronize_rng_state",
           "synchronize_rng_states", "threefry2x32", "uniform"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny
_ONE_BITS = 0x3F800000  # 1.0f

# the global key ``set_seed`` sets, as the JAX package's ``_GLOBAL_KEY``:
# ``PRNGKey(seed)`` as a uint32 numpy array [2] (None before a seed)
_GLOBAL_KEY = None


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds: key words ``k0, k1`` and counter words
    ``x0, x1`` (broadcastable int64 tensors of uint32 values) → the two
    output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        # key injection after every 4 rounds
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 tensor ``[2]`` on ``device``
    (the CPU when omitted: a key is host data its caller batches)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` per row: ``keys [B, 2]`` with ``data [B]`` (or
    one int for every row) → ``[B, 2]``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _MASK
    y0, y1 = threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (1, n))`` per row (uint32 words in an int64
    ``[B, n]``): the flat counter ``0 .. n-1`` through each row's key."""
    count = torch.arange(n, dtype=torch.int64, device=keys.device)[None]
    x0, x1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(count), count)
    return x0 ^ x1


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (1, n), float32, minval, maxval)`` per row
    → f32 ``[B, n]``."""
    mantissa = (random_bits(keys, n) >> 9) | _ONE_BITS  # a float in [1, 2)
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (1, n))`` (``mode="low"``) per row → f32
    ``[B, n]``."""
    return -torch.log(-torch.log(uniform(keys, n, _TINY, 1.0)))


def synchronize_rng_state(rng_type=None, generator=None) -> None:
    """Every process takes rank 0's state of one host stream (``numpy`` by
    default; ``python``, ``torch`` or ``generator``, the given
    ``torch.Generator``). The JAX package's ``jax`` stream is its global
    key: the port keeps one (:func:`get_rng_key`, for checkpoints), but
    its draws take explicit keys (:func:`prng_key`), so that stream
    raises."""
    import torch.distributed as dist

    from .dataclasses import RNGType
    from .operations import broadcast_object_list

    rng_type = RNGType(str(rng_type)) if rng_type is not None else RNGType.NUMPY
    if rng_type == RNGType.JAX:
        raise ValueError("rng_types: the 'jax' stream is the JAX package's global key; the "
                         "port's draws take explicit keys (utils.random.prng_key)")
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    if rng_type == RNGType.PYTHON:
        random.setstate(broadcast_object_list([random.getstate()])[0])
    elif rng_type == RNGType.NUMPY:
        np.random.set_state(broadcast_object_list([np.random.get_state()])[0])
    elif rng_type == RNGType.TORCH:
        torch.set_rng_state(broadcast_object_list([torch.get_rng_state()])[0])
    elif rng_type == RNGType.GENERATOR and generator is not None:
        generator.set_state(broadcast_object_list([generator.get_state()])[0])


def synchronize_rng_states(rng_types: Iterable, generator=None) -> None:
    """:func:`synchronize_rng_state` for each of ``rng_types``."""
    for rng_type in rng_types:
        synchronize_rng_state(rng_type, generator=generator)


def set_global_key(seed: int) -> None:
    """Set the global key to ``jax.random.PRNGKey(seed)`` (``set_seed``
    calls this)."""
    global _GLOBAL_KEY
    _GLOBAL_KEY = np.array([0, int(seed) & _MASK], dtype=np.uint32)


def get_rng_key():
    """The global key (a uint32 numpy array ``[2]``), or None before a
    seed."""
    return _GLOBAL_KEY


def capture_rng_states(include_torch: bool = True) -> dict:
    """Every host random stream and the global key, for a checkpoint, under
    the JAX package's names: ``python``, ``numpy``, ``jax_key`` (a uint32
    numpy array or None) and ``torch`` (the CPU generator's state). A
    pickle of it holds numpy and torch objects only, so either package
    restores the other's."""
    states = {"python": random.getstate(), "numpy": np.random.get_state(),
              "jax_key": None if _GLOBAL_KEY is None else np.array(_GLOBAL_KEY, dtype=np.uint32)}
    if include_torch:
        states["torch"] = torch.get_rng_state()
    return states


def restore_rng_states(states: dict) -> None:
    """Inverse of :func:`capture_rng_states` (a missing ``torch`` entry
    leaves torch's generator as it is)."""
    global _GLOBAL_KEY
    random.setstate(states["python"])
    np.random.set_state(states["numpy"])
    if states.get("jax_key") is not None:
        _GLOBAL_KEY = np.asarray(states["jax_key"]).astype(np.uint32)
    if states.get("torch") is not None:
        torch.set_rng_state(torch.as_tensor(states["torch"], dtype=torch.uint8))
