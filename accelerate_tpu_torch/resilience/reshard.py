"""The topology guard of a checkpoint load: the port of the part of
``accelerate_tpu.resilience.reshard`` that ``load_state`` calls.

Every shard index and every ``_COMMITTED`` manifest records the writing
mesh as ``{axis: size}`` (the port's axis names are the JAX package's).
:func:`check_topology` compares it with the loading mesh. Only a change of
the ``dp_replicate`` width changes a global shape (the fused ZeRO-1
buckets are padded to a multiple of it); any other refactorization
re-chunks by coordinates for free. That change raises
:class:`~accelerate_tpu_torch.sharded_checkpoint.CheckpointTopologyError`
naming both shapes unless the load is elastic, which re-pads the buckets
(:func:`~accelerate_tpu_torch.sharded_checkpoint.resize_padded_bucket`).
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..sharded_checkpoint import (  # noqa: F401  (public re-exports)
    CheckpointTopologyError,
    read_saved_mesh,
    resize_padded_bucket,
)

__all__ = ["check_topology", "describe_shapes", "is_elastic_compatible", "mesh_shape_dict",
           "saved_topology", "topology_matches"]


def mesh_shape_dict(mesh) -> Optional[dict]:
    """``{axis: size}`` of a mesh (None for none)."""
    if mesh is None:
        return None
    try:
        return {str(k): int(v) for k, v in dict(mesh.shape).items()}
    except (TypeError, AttributeError):
        return None


def _effective(shape: Optional[dict]) -> dict:
    """Size-1 axes are replication: ``{'dp': 2}`` matches ``{'dp': 2,
    'tp': 1}``."""
    return {k: int(v) for k, v in (shape or {}).items() if int(v) > 1}


def topology_matches(saved: Optional[dict], current: Optional[dict]) -> bool:
    """True when the two shapes are equivalent, or either is unknown."""
    if saved is None or current is None:
        return True
    return _effective(saved) == _effective(current)


def is_elastic_compatible(saved: Optional[dict], current: Optional[dict]) -> bool:
    """True when only the ``dp_replicate`` width differs."""
    s, c = _effective(saved), _effective(current)
    s.pop("dp_replicate", None)
    c.pop("dp_replicate", None)
    return s == c


def describe_shapes(saved: Optional[dict], current: Optional[dict]) -> str:
    def fmt(d):
        return "×".join(f"{k}={v}" for k, v in sorted(d.items())) if d else "<unknown>"

    return f"saved mesh {fmt(_effective(saved))} vs current mesh {fmt(_effective(current))}"


def check_topology(saved: Optional[dict], current: Optional[dict],
                   elastic: bool = False) -> bool:
    """Gate a load across topologies: False when the load needs no
    re-shard (same topology, or one that keeps every global shape); True
    when the ``dp_replicate`` width changed and ``elastic`` asks for the
    re-pad; :class:`CheckpointTopologyError` naming both shapes when it
    changed and ``elastic`` is false."""
    if topology_matches(saved, current):
        return False
    s, c = _effective(saved), _effective(current)
    if s.get("dp_replicate", 1) == c.get("dp_replicate", 1):
        return False
    if not elastic:
        raise CheckpointTopologyError(
            f"checkpoint topology mismatch: {describe_shapes(saved, current)} — the "
            "data-parallel replicate width changed, so ZeRO-1 optimizer bucket shapes differ. "
            "Pass elastic=True to load_state (or set ACCELERATE_ELASTIC_RESUME) to re-shard "
            "onto the current mesh, or relaunch with the saved topology.",
            saved=saved, current=current)
    return True


def saved_topology(input_dir: str) -> Optional[dict]:
    """The mesh a checkpoint directory was written under: the
    ``_COMMITTED`` manifest's ``mesh``, else the shard indices' (None when
    nothing recorded it)."""
    from ..checkpointing import COMMITTED_MARKER

    marker = os.path.join(input_dir, COMMITTED_MARKER)
    if os.path.isfile(marker):
        try:
            with open(marker) as f:
                mesh = json.load(f).get("mesh")
            if mesh:
                return {str(k): int(v) for k, v in mesh.items()}
        except (OSError, ValueError):
            pass
    for prefix in ("model", "optimizer"):
        mesh = read_saved_mesh(input_dir, prefix)
        if mesh:
            return mesh
    return None
