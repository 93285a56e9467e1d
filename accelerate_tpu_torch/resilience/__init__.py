"""Elastic training, the port of ``accelerate_tpu.resilience``: only the
topology guard a checkpoint load needs (:mod:`.reshard`) so far; the
supervisor, the cohort membership and the chaos harness are ROADMAP.md
Queue A item 12b."""

from .reshard import (
    CheckpointTopologyError,
    check_topology,
    is_elastic_compatible,
    mesh_shape_dict,
    saved_topology,
    topology_matches,
)

__all__ = ["CheckpointTopologyError", "check_topology", "is_elastic_compatible",
           "mesh_shape_dict", "saved_topology", "topology_matches"]
