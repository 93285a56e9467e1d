"""N-D parallelism configuration and the device mesh: the port of
``accelerate_tpu.parallelism_config``.

The sizes, the ``*_enabled`` properties, ``infer_dp_shard``,
``mesh_shape``, ``from_env``/``to_env``, ``describe``, ``dcn_mesh_shapes``
and the two presets are the JAX package's, line for line. ``build_mesh``
is where the two differ. JAX builds one ``jax.sharding.Mesh`` over the
devices of its processes. The port runs one process per device, and its
:class:`Mesh` is the canonical 7-axis grid of process ranks, in row-major
order over the JAX package's axis names (``pp, dp_replicate, dp_shard,
cp, sp, tp, ep``). Under a process group it holds a
``torch.distributed.device_mesh.DeviceMesh`` with those names, whose
per-axis groups carry the collectives.

Across nodes, the port's counterpart of a TPU slice is a node: a rank's
node is ``rank // LOCAL_WORLD_SIZE`` (the launcher's environment, which
torchrun and the JAX package's launcher set), or each process is its own
unit with ``ACCELERATE_HYBRID_MESH_GRANULE=process`` (JAX's
``process_is_granule``). With more than one unit, ``build_mesh`` lays the
rank grid out as JAX's ``mesh_utils.create_hybrid_device_mesh`` does: the
factors of :meth:`ParallelismConfig.dcn_mesh_shapes` on the outer axes,
across units, and each unit's ranks, in order, on the inner axes. A unit
count the axes cannot absorb raises JAX's ``ValueError``; the grid is never
flattened. With one unit the grid is the ranks in row-major order.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = [
    "BATCH_AXES",
    "DP_AXES",
    "DP_CP_AXES",
    "DP_SHARD_CP_AXES",
    "MESH_AXIS_NAMES",
    "Mesh",
    "ParallelismConfig",
    "axis_sizes",
    "get_1d_dp_config",
    "get_fsdp_config",
]

MESH_AXIS_NAMES = ("pp", "dp_replicate", "dp_shard", "cp", "sp", "tp", "ep")
DP_AXES = ("dp_replicate", "dp_shard")
DP_SHARD_CP_AXES = ("dp_shard", "cp")
DP_CP_AXES = ("dp_replicate", "dp_shard", "cp")
BATCH_AXES = ("dp_replicate", "dp_shard", "cp", "sp")



class Mesh:
    """The port's device mesh: the canonical axes over the process ranks.

    ``shape`` is an ordered ``{axis: size}`` as ``jax.sharding.Mesh.shape``
    gives it, ``devices`` the rank grid, ``rank`` and ``coords`` this
    process's place in it. ``devices`` is the ranks in row-major order
    unless a grid is given (a multi-node layout). ``device_mesh`` is the
    torch ``DeviceMesh`` under a process group (``None`` for a mesh built
    without one, as spec inference and the tests use), and :meth:`group`
    the process group of one axis, ``None`` when that axis has size 1."""

    axis_names = MESH_AXIS_NAMES

    def __init__(self, shape, rank: int = 0, device_mesh=None, devices=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(MESH_AXIS_NAMES):
            raise ValueError(f"a mesh needs {len(MESH_AXIS_NAMES)} sizes "
                             f"({MESH_AXIS_NAMES}), got {shape}")
        self.shape = dict(zip(MESH_AXIS_NAMES, shape))
        self.size = int(np.prod(shape))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside a mesh of {self.size}")
        self.rank = rank
        self.devices = (np.arange(self.size).reshape(shape) if devices is None
                        else np.asarray(devices).reshape(shape))
        if sorted(self.devices.ravel().tolist()) != list(range(self.size)):
            raise ValueError(f"a mesh grid must hold every rank once: {self.devices.ravel()}")
        where = np.argwhere(self.devices == rank)[0]
        self.coords = dict(zip(MESH_AXIS_NAMES, (int(c) for c in where)))
        self.device_mesh = device_mesh

    def group(self, axis: str):
        """The process group along ``axis`` (``None`` when its size is 1)."""
        if self.shape[axis] == 1:
            return None
        if self.device_mesh is None:
            raise RuntimeError(f"mesh axis {axis!r} has size {self.shape[axis]} but the mesh "
                               "was built without a process group")
        return self.device_mesh.get_group(axis)

    @property
    def sequence_axis(self) -> Optional[str]:
        """The axis (of size > 1) the sequence dim is split over: ``cp``,
        else ``sp``, as the JAX package's loader picks it; None for none."""
        return next((a for a in ("cp", "sp") if self.shape[a] > 1), None)

    def sequence_span(self, chunk: int) -> tuple:
        """``(start, total)`` for this rank's ``chunk`` positions of a
        sequence split over :attr:`sequence_axis`: the chunk's first global
        position and the global length (``(0, chunk)`` when not split)."""
        axis = self.sequence_axis
        if axis is None:
            return 0, chunk
        return chunk * self.coords[axis], chunk * self.shape[axis]

    def __repr__(self) -> str:
        return "Mesh(" + ", ".join(f"{a}={s}" for a, s in self.shape.items()) + f"; rank={self.rank})"


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a :class:`Mesh` or of a plain mapping."""
    return dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)


@dataclass
class ParallelismConfig:
    """Sizes for each mesh axis; ``dp_shard_size=-1`` infers it from the
    device count. ``cp_rotate_method`` keeps the JAX package's values."""

    pp_size: int = 1
    dp_replicate_size: int = 1
    dp_shard_size: int = 1
    cp_size: int = 1
    sp_size: int = 1
    tp_size: int = 1
    ep_size: int = 1
    cp_rotate_method: str = "allgather"  # "allgather" | "ring" | "zigzag"

    def __post_init__(self):
        for name in ("pp_size", "dp_replicate_size", "cp_size", "sp_size", "tp_size", "ep_size"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.dp_shard_size == 0 or self.dp_shard_size < -1:
            raise ValueError(f"dp_shard_size must be -1 (infer) or >= 1, got {self.dp_shard_size}")
        if self.cp_size > 1 and self.sp_size > 1:
            raise ValueError("cp_size and sp_size cannot both be > 1 (pick ring-CP or Ulysses-SP)")
        if self.cp_rotate_method not in ("allgather", "ring", "zigzag"):
            raise ValueError(
                f"cp_rotate_method must be 'allgather', 'ring' or 'zigzag', got {self.cp_rotate_method}"
            )

    @property
    def non_dp_shard_size(self) -> int:
        return (self.pp_size * self.dp_replicate_size * self.cp_size * self.sp_size
                * self.tp_size * self.ep_size)

    def infer_dp_shard(self, num_devices: int) -> int:
        if self.dp_shard_size != -1:
            return self.dp_shard_size
        rest = self.non_dp_shard_size
        if num_devices % rest != 0:
            raise ValueError(
                f"cannot infer dp_shard_size: {num_devices} devices not divisible by "
                f"product of other axes {rest}"
            )
        return num_devices // rest

    def total_size(self, num_devices: Optional[int] = None) -> int:
        dp_shard = self.dp_shard_size
        if dp_shard == -1:
            if num_devices is None:
                raise ValueError("dp_shard_size=-1 needs num_devices to infer")
            dp_shard = self.infer_dp_shard(num_devices)
        return self.non_dp_shard_size * dp_shard

    @property
    def dp_enabled(self) -> bool:
        return self.dp_replicate_size > 1 or self.dp_shard_size == -1 or self.dp_shard_size > 1

    @property
    def fsdp_enabled(self) -> bool:
        return self.dp_shard_size == -1 or self.dp_shard_size > 1

    @property
    def hsdp_enabled(self) -> bool:
        return self.fsdp_enabled and self.dp_replicate_size > 1

    @property
    def tp_enabled(self) -> bool:
        return self.tp_size > 1

    @property
    def cp_enabled(self) -> bool:
        return self.cp_size > 1

    @property
    def sp_enabled(self) -> bool:
        return self.sp_size > 1

    @property
    def ep_enabled(self) -> bool:
        return self.ep_size > 1

    @property
    def pp_enabled(self) -> bool:
        return self.pp_size > 1

    @classmethod
    def from_env(cls) -> "ParallelismConfig":
        def _get(name: str, default: int) -> int:
            return int(os.environ.get(f"PARALLELISM_CONFIG_{name}", default))

        return cls(
            pp_size=_get("PP_SIZE", 1),
            dp_replicate_size=_get("DP_REPLICATE_SIZE", 1),
            dp_shard_size=_get("DP_SHARD_SIZE", 1),
            cp_size=_get("CP_SIZE", 1),
            sp_size=_get("SP_SIZE", 1),
            tp_size=_get("TP_SIZE", 1),
            ep_size=_get("EP_SIZE", 1),
            cp_rotate_method=os.environ.get("PARALLELISM_CONFIG_CP_ROTATE_METHOD", "allgather"),
        )

    def to_env(self) -> dict:
        return {
            "PARALLELISM_CONFIG_PP_SIZE": str(self.pp_size),
            "PARALLELISM_CONFIG_DP_REPLICATE_SIZE": str(self.dp_replicate_size),
            "PARALLELISM_CONFIG_DP_SHARD_SIZE": str(self.dp_shard_size),
            "PARALLELISM_CONFIG_CP_SIZE": str(self.cp_size),
            "PARALLELISM_CONFIG_SP_SIZE": str(self.sp_size),
            "PARALLELISM_CONFIG_TP_SIZE": str(self.tp_size),
            "PARALLELISM_CONFIG_EP_SIZE": str(self.ep_size),
            "PARALLELISM_CONFIG_CP_ROTATE_METHOD": self.cp_rotate_method,
        }

    def mesh_shape(self, num_devices: int) -> tuple:
        dp_shard = self.infer_dp_shard(num_devices)
        shape = (self.pp_size, self.dp_replicate_size, dp_shard, self.cp_size, self.sp_size,
                 self.tp_size, self.ep_size)
        total = int(np.prod(shape))
        if total != num_devices:
            raise ValueError(
                f"mesh {dict(zip(MESH_AXIS_NAMES, shape))} has size {total} but "
                f"{num_devices} devices are available"
            )
        return shape

    def dcn_mesh_shapes(self, num_devices: int, num_slices: int):
        """``(per_slice_shape, dcn_shape)``: the slice count lands on the
        outermost axes first (``pp``, then ``dp_replicate``), unless
        ``ACCELERATE_DCN_MESH_SHAPE`` (7 comma-separated sizes) says
        otherwise."""
        shape = self.mesh_shape(num_devices)
        explicit = os.environ.get("ACCELERATE_DCN_MESH_SHAPE", "").strip()
        if explicit:
            dcn = tuple(int(x) for x in explicit.split(","))
            if len(dcn) != len(shape):
                raise ValueError(
                    f"ACCELERATE_DCN_MESH_SHAPE needs {len(shape)} comma-separated sizes "
                    f"(axes {MESH_AXIS_NAMES}), got {explicit!r}"
                )
        else:
            dcn_list = [1] * len(shape)
            remaining = num_slices
            for idx in (0, 1):  # pp, dp_replicate
                if remaining == 1:
                    break
                f = math.gcd(shape[idx], remaining)
                dcn_list[idx] = f
                remaining //= f
            if remaining != 1:
                raise ValueError(
                    f"cannot place {num_slices} slices across the outer mesh axes: "
                    f"pp={shape[0]} x dp_replicate={shape[1]} does not absorb the slice "
                    f"count. Raise pp_size/dp_replicate_size to a multiple of the slice "
                    f"count, or set ACCELERATE_DCN_MESH_SHAPE to place another axis "
                    f"(e.g. dp_shard) across DCN explicitly."
                )
            dcn = tuple(dcn_list)
        if int(np.prod(dcn)) != num_slices:
            raise ValueError(
                f"dcn mesh shape {dcn} has size {int(np.prod(dcn))} but there are "
                f"{num_slices} slices"
            )
        bad = [MESH_AXIS_NAMES[i] for i, (s, d) in enumerate(zip(shape, dcn))
               if d < 1 or s % d != 0]
        if bad:
            raise ValueError(
                f"dcn factor does not divide the mesh axis size for {bad} "
                f"(mesh {shape}, dcn {dcn})"
            )
        per_slice = tuple(s // d for s, d in zip(shape, dcn))
        return per_slice, dcn

    @staticmethod
    def _units(num_devices: int) -> list:
        """The DCN unit of each rank: its node (``rank // LOCAL_WORLD_SIZE``,
        one node when the launcher does not say), or the rank itself under
        ``ACCELERATE_HYBRID_MESH_GRANULE=process``."""
        granule = os.environ.get("ACCELERATE_HYBRID_MESH_GRANULE", "slice").strip().lower()
        if granule == "process":
            return list(range(num_devices))
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "").strip() or num_devices)
        return [r // max(local, 1) for r in range(num_devices)]

    def rank_grid(self, num_devices: int) -> np.ndarray:
        """The ranks laid out on the mesh's axes: row-major on one unit;
        across units, JAX's hybrid layout (the DCN factors on the outer
        axes, a unit's ranks in order on the inner ones)."""
        shape = self.mesh_shape(num_devices)
        units = self._units(num_devices)
        keys = sorted(set(units))
        if len(keys) == 1:
            return np.arange(num_devices).reshape(shape)
        per_unit, dcn = self.dcn_mesh_shapes(num_devices, len(keys))
        members = [[r for r, u in enumerate(units) if u == k] for k in keys]
        if any(len(m) != int(np.prod(per_unit)) for m in members):
            raise ValueError(f"the DCN units hold {[len(m) for m in members]} ranks; each must "
                             f"hold {int(np.prod(per_unit))} (mesh {shape}, dcn {dcn})")
        blocks = np.asarray(members).reshape(*dcn, *per_unit)
        n = len(shape)
        # unit position i on axis a and local position j: i * per_unit[a] + j
        order = [ax for a in range(n) for ax in (a, n + a)]
        return blocks.transpose(order).reshape(shape)

    def build_mesh(self, num_devices: Optional[int] = None, device_type: Optional[str] = None,
                   rank: Optional[int] = None) -> Mesh:
        """The :class:`Mesh` of this config over the process group's ranks
        (its world size and rank by default), laid out by :meth:`rank_grid`,
        with a ``DeviceMesh`` of type ``device_type`` (``"cuda"`` or
        ``"cpu"``) when a process group is running. Without one,
        ``num_devices`` (1 by default) and ``rank`` (0) describe the grid and
        nothing is communicated. The config must use every process: one
        process is one device."""
        import torch.distributed as dist

        live = dist.is_available() and dist.is_initialized()
        if num_devices is None:
            num_devices = dist.get_world_size() if live else 1
        if rank is None:
            rank = dist.get_rank() if live else 0
        requested = self.total_size(num_devices)
        if requested != num_devices:
            raise ValueError(
                f"parallelism config needs {requested} devices but {num_devices} processes run "
                "(the port runs one process per device, and a mesh uses them all)"
            )
        shape = self.mesh_shape(num_devices)
        grid = self.rank_grid(num_devices)
        device_mesh = None
        if live:
            import torch
            from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

            if dist.get_world_size() != num_devices:
                raise ValueError(f"the process group has {dist.get_world_size()} ranks, "
                                 f"not {num_devices}")
            if np.array_equal(grid.ravel(), np.arange(num_devices)):
                device_mesh = init_device_mesh(device_type or "cuda", shape,
                                               mesh_dim_names=MESH_AXIS_NAMES)
            else:
                device_mesh = DeviceMesh(device_type or "cuda", torch.from_numpy(grid),
                                         mesh_dim_names=MESH_AXIS_NAMES)
        return Mesh(shape, rank=rank, device_mesh=device_mesh, devices=grid)

    def describe(self, num_devices: Optional[int] = None) -> str:
        if num_devices is not None:
            shape = self.mesh_shape(num_devices)
        else:
            shape = (self.pp_size, self.dp_replicate_size, self.dp_shard_size, self.cp_size,
                     self.sp_size, self.tp_size, self.ep_size)
        return " x ".join(f"{n}={s}" for n, s in zip(MESH_AXIS_NAMES, shape))


def get_1d_dp_config(num_devices: int) -> ParallelismConfig:
    """Pure data parallelism over every device."""
    return ParallelismConfig(dp_replicate_size=num_devices)


def get_fsdp_config(num_devices: int) -> ParallelismConfig:
    """Full parameter sharding over every device."""
    return ParallelismConfig(dp_shard_size=num_devices)
