"""The port's ``ParallelismConfig`` and mesh against the JAX package's, over
a table of sizes and device counts: sizes and ``*_enabled`` properties,
``infer_dp_shard``, ``total_size``, ``mesh_shape``, ``describe``,
``to_env``/``from_env`` (and their round trip), ``dcn_mesh_shapes``, the
presets, the errors, and the mesh's axis sizes; and the environment
helpers of ``utils.environment`` on a table of values. No processes: the
port's mesh is built without a process group, the JAX package's on its
virtual CPU devices.
"""

import numpy as np
import pytest

from accelerate_tpu import parallelism_config as jpc
from accelerate_tpu.utils import environment as jenv
from accelerate_tpu_torch import parallelism_config as tpc
from accelerate_tpu_torch.utils import environment as tenv

CASES = [
    # (ParallelismConfig kwargs, device count)
    ({}, 1),
    ({"dp_replicate_size": 8}, 8),
    ({"dp_shard_size": 8}, 8),
    ({"dp_shard_size": -1}, 8),
    ({"dp_shard_size": 2, "tp_size": 2}, 4),
    ({"dp_replicate_size": 2, "dp_shard_size": 2, "tp_size": 2}, 8),
    ({"dp_replicate_size": 2, "dp_shard_size": -1}, 8),
    ({"tp_size": 4}, 4),
    ({"cp_size": 2, "dp_shard_size": 2, "cp_rotate_method": "ring"}, 4),
    ({"sp_size": 2, "dp_replicate_size": 2}, 4),
    ({"pp_size": 2, "dp_replicate_size": 2, "ep_size": 2}, 8),
    ({"dp_shard_size": -1, "tp_size": 2}, 6),
    ({"dp_shard_size": -1, "tp_size": 4}, 6),  # 6 does not split over tp 4
    ({"dp_replicate_size": 2}, 4),  # too few axes for the devices
]
PROPS = ("non_dp_shard_size", "dp_enabled", "fsdp_enabled", "hsdp_enabled", "tp_enabled",
         "cp_enabled", "sp_enabled", "ep_enabled", "pp_enabled")


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the same exception class, or the same value
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("kwargs,n", CASES)
def test_config_methods_match_jax(kwargs, n):
    j, t = jpc.ParallelismConfig(**kwargs), tpc.ParallelismConfig(**kwargs)
    assert t == tpc.ParallelismConfig(**kwargs)
    for prop in PROPS:
        assert getattr(t, prop) == getattr(j, prop), prop
    for name, call in (("infer_dp_shard", lambda c: c.infer_dp_shard(n)),
                       ("total_size", lambda c: c.total_size(n)),
                       ("mesh_shape", lambda c: c.mesh_shape(n)),
                       ("describe", lambda c: c.describe()),
                       ("describe_n", lambda c: c.describe(n)),
                       ("dcn1", lambda c: c.dcn_mesh_shapes(n, 1)),
                       ("dcn2", lambda c: c.dcn_mesh_shapes(n, 2))):
        assert _outcome(lambda: call(t)) == _outcome(lambda: call(j)), name
    assert t.to_env() == j.to_env()


@pytest.mark.parametrize("kwargs,n", CASES)
def test_env_round_trip(kwargs, n, monkeypatch):
    cfg = tpc.ParallelismConfig(**kwargs)
    for key, value in cfg.to_env().items():
        monkeypatch.setenv(key, value)
    assert tpc.ParallelismConfig.from_env() == cfg
    assert jpc.ParallelismConfig.from_env() == jpc.ParallelismConfig(**kwargs)


@pytest.mark.parametrize("kwargs,n", CASES)
def test_mesh_axes_match_jax(kwargs, n):
    import jax

    t = tpc.ParallelismConfig(**kwargs)
    j = jpc.ParallelismConfig(**kwargs)
    outcome = _outcome(lambda: dict(j.build_mesh(jax.devices()[:n]).shape))
    needs = _outcome(lambda: t.total_size(n))
    if needs[0] == "ok" and needs[1] < n:
        # JAX runs a smaller mesh on the first devices; the port runs one
        # process per device, and a mesh must use every process
        assert outcome[0] == "ok" and int(np.prod(list(outcome[1].values()))) == needs[1]
        with pytest.raises(ValueError, match="one process per device"):
            t.build_mesh(n)
        return
    if outcome[0] == "raises":
        with pytest.raises(ValueError):
            t.build_mesh(n)
        return
    mesh = t.build_mesh(n)
    assert list(mesh.shape.items()) == list(outcome[1].items())
    assert mesh.axis_names == tpc.MESH_AXIS_NAMES == jpc.MESH_AXIS_NAMES
    assert mesh.devices.shape == tuple(mesh.shape.values()) and mesh.size == n
    last = t.build_mesh(n, rank=n - 1)
    assert all(c == s - 1 for c, s in zip(last.coords.values(), last.shape.values()))


def test_constants_and_presets_match_jax():
    for name in ("DP_AXES", "DP_SHARD_CP_AXES", "DP_CP_AXES", "BATCH_AXES"):
        assert getattr(tpc, name) == getattr(jpc, name), name
    for n in (1, 4, 8):
        assert tpc.get_1d_dp_config(n).mesh_shape(n) == jpc.get_1d_dp_config(n).mesh_shape(n)
        assert tpc.get_fsdp_config(n).mesh_shape(n) == jpc.get_fsdp_config(n).mesh_shape(n)


@pytest.mark.parametrize("kwargs", [{"tp_size": 0}, {"dp_shard_size": 0},
                                    {"dp_shard_size": -2}, {"cp_size": 2, "sp_size": 2},
                                    {"cp_rotate_method": "alltoall"}])
def test_invalid_configs_raise_as_in_jax(kwargs):
    with pytest.raises(ValueError):
        jpc.ParallelismConfig(**kwargs)
    with pytest.raises(ValueError):
        tpc.ParallelismConfig(**kwargs)


def test_dcn_override_matches_jax_and_multi_slice_mesh_raises(monkeypatch):
    """The multi-slice mesh raised until nodes took the place of slices; the
    name is kept, and the case now builds: with one node the override is
    not read (JAX's one-slice path), with two it places dp_shard across
    the nodes exactly as JAX's grid over two fake slices."""
    monkeypatch.setenv("ACCELERATE_DCN_MESH_SHAPE", "1,1,2,1,1,1,1")
    cfg = dict(dp_replicate_size=2, dp_shard_size=2, tp_size=2)
    assert (tpc.ParallelismConfig(**cfg).dcn_mesh_shapes(8, 2)
            == jpc.ParallelismConfig(**cfg).dcn_mesh_shapes(8, 2))
    one_node = tpc.ParallelismConfig(**cfg).build_mesh(8)
    np.testing.assert_array_equal(one_node.devices.ravel(), np.arange(8))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    got = tpc.ParallelismConfig(**cfg).build_mesh(8).devices
    np.testing.assert_array_equal(got, _jax_grid(cfg, 8, 2))
    assert not np.array_equal(got.ravel(), np.arange(8))


def _jax_grid(cfg, n, slices):
    """JAX's device-id grid for ``cfg`` over ``n`` fake devices in
    ``slices`` slices (ids in order, slice = id // (n / slices))."""
    from accelerate_tpu.test_utils import fake_slice_devices

    mesh = jpc.ParallelismConfig(**cfg).build_mesh(devices=fake_slice_devices(n, slices))
    return np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("cfg,slices", [
    ({"dp_replicate_size": 2, "dp_shard_size": 4}, 2),
    ({"pp_size": 2, "dp_replicate_size": 2, "dp_shard_size": 2}, 4),
    ({"pp_size": 2, "dp_replicate_size": 2, "tp_size": 2}, 2),
])
def test_multi_node_rank_grid_matches_jax_fake_slices(cfg, slices, monkeypatch):
    """A node (``rank // LOCAL_WORLD_SIZE``) is the port's slice: the rank
    grid equals JAX's ``build_mesh`` device-id grid over fake slices, and
    every index of the outermost split axis lies inside one node."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(8 // slices))
    mesh = tpc.ParallelismConfig(**cfg).build_mesh(8)
    np.testing.assert_array_equal(mesh.devices, _jax_grid(cfg, 8, slices))
    node = mesh.devices // (8 // slices)
    for r in range(cfg["dp_replicate_size"]):  # one dp_replicate row, one node
        for p in range(cfg.get("pp_size", 1)):
            assert len(np.unique(node[p, r])) == 1
    for rank in range(8):  # each rank's coordinates name its place in the grid
        coords = tpc.ParallelismConfig(**cfg).build_mesh(8, rank=rank).coords
        assert mesh.devices[tuple(coords.values())] == rank


def test_multi_node_unfactorable_raises_as_jax(monkeypatch):
    from accelerate_tpu.test_utils import fake_slice_devices

    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="ACCELERATE_DCN_MESH_SHAPE"):
        tpc.ParallelismConfig(dp_shard_size=8).build_mesh(8)
    with pytest.raises(ValueError):
        jpc.ParallelismConfig(dp_shard_size=8).build_mesh(devices=fake_slice_devices(8, 2))


def test_multi_node_granule_process_matches_jax(monkeypatch):
    """``ACCELERATE_HYBRID_MESH_GRANULE=process``: each process is a unit
    (JAX's ``process_is_granule``; a fake device's process is its slice)."""
    monkeypatch.setenv("ACCELERATE_HYBRID_MESH_GRANULE", "process")
    cfg = {"pp_size": 2, "dp_replicate_size": 4}
    np.testing.assert_array_equal(tpc.ParallelismConfig(**cfg).build_mesh(8).devices,
                                  _jax_grid(cfg, 8, 8))
    with pytest.raises(ValueError, match="ACCELERATE_DCN_MESH_SHAPE"):
        tpc.ParallelismConfig(dp_replicate_size=2, dp_shard_size=4).build_mesh(8)
    monkeypatch.setenv("ACCELERATE_DCN_MESH_SHAPE", "1,2,4,1,1,1,1")
    cfg = {"dp_replicate_size": 2, "dp_shard_size": 4}
    np.testing.assert_array_equal(tpc.ParallelismConfig(**cfg).build_mesh(8).devices,
                                  _jax_grid(cfg, 8, 8))


ENV_VALUES = [None, "", "1", "0", "yes", "No", " true ", "off", "maybe", "3", "-2", "1.5e3",
              "  ", "x7"]
PARSERS = [("parse_flag_from_env", (False,)), ("parse_flag_from_env", (True,)),
           ("parse_choice_from_env", ("no",)), ("parse_seconds_from_env", (2.5,)),
           ("parse_int_from_env", (4,)), ("parse_optional_int_from_env", (None,)),
           ("parse_optional_float_from_env", (None,)), ("get_int_from_env", (9,))]


@pytest.mark.parametrize("value", ENV_VALUES)
def test_environment_helpers_match_jax(value, monkeypatch):
    key = "ACCELERATE_TORCH_PORT_ENV_PROBE"
    if value is None:
        monkeypatch.delenv(key, raising=False)
    else:
        monkeypatch.setenv(key, value)
    for name, args in PARSERS:
        keys = [key] if name == "get_int_from_env" else key
        assert (_outcome(lambda: getattr(tenv, name)(keys, *args))
                == _outcome(lambda: getattr(jenv, name)(keys, *args))), name
    if value is not None and value.strip().lower() in ("1", "0", "yes", "no", "true", "off"):
        assert tenv.str_to_bool(value) == jenv.str_to_bool(value)


def test_patch_environment_and_distributed_information_match_jax(monkeypatch):
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.delenv("ACCELERATE_PROCESS_ID", raising=False)
    with tenv.patch_environment(accelerate_num_processes=8, local_world_size=None):
        assert tenv.get_cpu_distributed_information() == {
            "rank": 3, "world_size": 8, "local_rank": 1, "local_world_size": 1}
    with jenv.patch_environment(accelerate_num_processes=8, local_world_size=None):
        import os

        assert os.environ["ACCELERATE_NUM_PROCESSES"] == "8"
    assert "ACCELERATE_NUM_PROCESSES" not in __import__("os").environ
    assert tenv.get_current_device_type() == "cpu"
