"""The port's sharding decisions against the JAX package's, with no
processes: spec inference reads only the mesh's axis sizes.

- ``infer_param_specs`` path by path for tiny Llama with and without
  ``llama_tp_rules``, tiny Llama, its MoE variant (4 experts) and tiny
  BERT under the models' own ``llama_shard_rules`` / ``bert_shard_rules``,
  tiny ResNet with ``resnet_shard_rules`` and tiny T5 with
  ``t5_shard_rules``, on the meshes (dp_shard 2, tp 2), (dp_replicate
  2, dp_shard 2, tp 2), (dp_shard 8), (tp 4) and (dp_replicate 8);
- each rank's block (offset and size per dim) against the JAX sharding's
  ``devices_indices_map`` for the device at the same mesh coordinates, and
  both refusing a split that does not divide;
- ``make_sharding_plan(...).fused_zero1`` and the fused ZeRO-1 bucket plan
  (names, chunk sizes, ``collective_bytes``), ``tree_specs_like``,
  ``zero1_state_specs`` and ``canonicalize_spec``;
- what ``llama_tp_rules`` shard on the stacked ``[L, in, out]`` tree
  (ROADMAP.md Queue C): the table is the JAX package's own behaviour.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from accelerate_tpu.models import resnet as jresnet
from accelerate_tpu.models import t5 as jt5
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.parallel import sharding as jsh
from accelerate_tpu.parallelism_config import ParallelismConfig as JParallelismConfig
from accelerate_tpu_torch.models import resnet as tresnet
from accelerate_tpu_torch.models import t5 as tt5
from accelerate_tpu_torch.models import transformer as ttr
from accelerate_tpu_torch.parallel import sharding as tsh
from accelerate_tpu_torch.parallelism_config import ParallelismConfig

MESHES = {
    "dp_shard2_tp2": {"dp_shard_size": 2, "tp_size": 2},
    "dp_replicate2_dp_shard2_tp2": {"dp_replicate_size": 2, "dp_shard_size": 2, "tp_size": 2},
    "dp_shard8": {"dp_shard_size": 8},
    "tp4": {"tp_size": 4},
    "dp_replicate8": {"dp_replicate_size": 8},
}


@pytest.fixture(scope="module")
def models():
    key = jax.random.PRNGKey(0)
    return {
        "llama": (jt.init_llama(jt.LlamaConfig.tiny(), key), None, None),
        "llama_tp": (jt.init_llama(jt.LlamaConfig.tiny(), key), jsh.llama_tp_rules(),
                     tsh.llama_tp_rules()),
        "llama_shard": (jt.init_llama(jt.LlamaConfig.tiny(), key), jt.llama_shard_rules(),
                        ttr.llama_shard_rules()),
        "llama_moe_shard": (jt.init_llama(dataclasses.replace(jt.LlamaConfig.tiny(),
                                                              moe_experts=4), key),
                            jt.llama_shard_rules(), ttr.llama_shard_rules()),
        "bert_shard": (jt.init_bert(jt.BertConfig.tiny(), key), jt.bert_shard_rules(),
                       ttr.bert_shard_rules()),
        "resnet": (jresnet.init_resnet(jresnet.ResNetConfig.tiny(), key),
                   jresnet.resnet_shard_rules(), tresnet.resnet_shard_rules()),
        "t5": (jt5.init_t5(jt5.T5Config.tiny(), key), jt5.t5_shard_rules(),
               tt5.t5_shard_rules()),
    }


def _n(kwargs) -> int:
    return ParallelismConfig(**kwargs).total_size()


def _jax_mesh(kwargs):
    return JParallelismConfig(**kwargs).build_mesh(jax.devices()[:_n(kwargs)])


def _jax_specs(params, mesh, kwargs, rules) -> dict:
    specs = jsh.infer_param_specs(params, mesh, JParallelismConfig(**kwargs), rules)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jsh._path_str(p): s for p, s in flat}


def _port_specs(params_np, kwargs, rules) -> dict:
    cfg = ParallelismConfig(**kwargs)
    specs = tsh.infer_param_specs(params_np, cfg.build_mesh(_n(kwargs)), cfg, rules)
    out = {}
    tsh._map_with_path(lambda path, s: out.__setitem__(path, s), specs)
    return out


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _shapes(params_np) -> dict:
    out = {}
    tsh._map_with_path(lambda path, x: out.__setitem__(path, x.shape), params_np)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("model", ["llama", "llama_tp", "llama_shard", "llama_moe_shard",
                                   "bert_shard", "resnet", "t5"])
def test_specs_and_blocks_match_jax(models, model, mesh_name):
    jparams, jrules, trules = models[model]
    kwargs = MESHES[mesh_name]
    jmesh = _jax_mesh(kwargs)
    want = _jax_specs(jparams, jmesh, kwargs, jrules)
    params_np = _np_tree(jparams)
    got = _port_specs(params_np, kwargs, trules)
    assert set(got) == set(want)
    for path, spec in got.items():
        assert tuple(spec) == tuple(want[path]), (path, spec, want[path])
    # each rank's block against JAX's devices_indices_map at the same coordinates
    shapes = _shapes(params_np)
    coords = {dev: dict(zip(jmesh.axis_names, (int(c) for c in idx)))
              for idx, dev in np.ndenumerate(jmesh.devices)}
    sizes = dict(jmesh.shape)
    for path, spec in got.items():
        shape = shapes[path]
        sharding = NamedSharding(jmesh, want[path])
        divides = all(
            shape[d] % int(np.prod([sizes[a] for a in tsh._dim_axes(e)])) == 0
            for d, e in enumerate(spec))
        if not divides:
            with pytest.raises(ValueError):
                jax.device_put(np.zeros(shape, np.float32), sharding)
            with pytest.raises(ValueError, match="not divisible"):
                tsh.shard_index(spec, shape, sizes, next(iter(coords.values())))
            continue
        for dev, index in sharding.devices_indices_map(shape).items():
            mine = tsh.shard_index(spec, shape, sizes, coords[dev])
            assert [s.indices(n)[:2] for s, n in zip(index, shape)] == [
                (s.start, s.stop) for s in mine], (path, coords[dev])


def test_llama_tp_rules_on_the_stacked_tree_shard_what_queue_c_records(models):
    """On the stacked tree the ``[in, out]`` rules land one dim to the left:
    ``tp`` splits the contraction dim of wq/wk/wv/w1/w3 and the layer axis
    of wo/w2, FSDP takes what is left; the port reproduces the JAX
    package's decisions."""
    jparams, jrules, trules = models["llama_tp"]
    kwargs = MESHES["dp_shard2_tp2"]
    want = {
        "layers/wq/kernel": ("dp_shard", "tp"), "layers/wk/kernel": ("dp_shard", "tp"),
        "layers/wv/kernel": ("dp_shard", "tp"), "layers/w1/kernel": ("dp_shard", "tp"),
        "layers/w3/kernel": ("dp_shard", "tp"),
        "layers/wo/kernel": ("tp", "dp_shard"), "layers/w2/kernel": ("tp", "dp_shard"),
        "embed_tokens/embedding": ("tp", "dp_shard"), "lm_head/kernel": ("dp_shard", "tp"),
        "layers/attn_norm/scale": (), "layers/mlp_norm/scale": (), "final_norm/scale": (),
    }
    j = _jax_specs(jparams, _jax_mesh(kwargs), kwargs, jrules)
    t = _port_specs(_np_tree(jparams), kwargs, trules)
    for path, spec in want.items():
        assert tuple(j[path]) == tuple(t[path]) == spec, (path, j[path], t[path])


@pytest.mark.parametrize("mesh_name,bucket_bytes", [("dp_replicate8", 1 << 16),
                                                    ("dp_replicate8", None),
                                                    ("dp_shard8", None),
                                                    ("dp_replicate2_dp_shard2_tp2", 1 << 16)])
def test_plan_and_bucket_plan_match_jax(models, mesh_name, bucket_bytes):
    jparams, _, _ = models["llama"]
    kwargs = MESHES[mesh_name]
    pc = ParallelismConfig(**kwargs)
    jplan = jsh.make_sharding_plan(jparams, _jax_mesh(kwargs), JParallelismConfig(**kwargs),
                                   zero1_axis="dp_replicate", zero1_bucket_bytes=bucket_bytes)
    tplan = tsh.make_sharding_plan(_np_tree(jparams), pc.build_mesh(_n(kwargs)), pc,
                                   zero1_axis="dp_replicate", zero1_bucket_bytes=bucket_bytes)
    assert tplan.fused_zero1 == jplan.fused_zero1
    assert tplan.zero1_collective_bytes() == jplan.zero1_collective_bytes()
    if jplan.fused_zero1:
        jz, tz = jplan.zero1, tplan.zero1
        assert tz.bucket_names == jz.bucket_names and tz.num_buckets > 0
        assert [tz.chunk_size(n) for n in tz.bucket_names] == [
            jz.chunk_size(n) for n in jz.bucket_names]
        assert tz.bucket_sizes == jz.bucket_sizes
        assert tz.collective_bytes == jz.collective_bytes
        assert tz.n_elements == jz.n_elements


def test_state_specs_and_canonical_form_match_jax(models):
    jparams, _, _ = models["llama"]
    kwargs = MESHES["dp_replicate8"]
    jmesh = _jax_mesh(kwargs)
    pc = ParallelismConfig(**kwargs)
    mesh = pc.build_mesh(8)
    params_np = _np_tree(jparams)
    jspecs = jsh.infer_param_specs(jparams, jmesh, JParallelismConfig(**kwargs))
    tspecs = tsh.infer_param_specs(params_np, mesh, pc)
    state = {"mu": params_np, "nu": params_np, "count": np.zeros((), np.int32)}
    jstate = {"mu": jparams, "nu": jparams, "count": np.zeros((), np.int32)}
    jz = jsh.zero1_state_specs(jstate, jsh.tree_specs_like(jstate, jparams, jspecs), jmesh)
    tz = tsh.zero1_state_specs(state, tsh.tree_specs_like(state, params_np, tspecs), mesh)
    jflat = jax.tree_util.tree_flatten_with_path(jz, is_leaf=lambda x: isinstance(x, JP))[0]
    tflat = {}
    tsh._map_with_path(lambda path, s: tflat.__setitem__(path, s), tz)
    assert {jsh._path_str(p): tuple(s) for p, s in jflat} == {
        k: tuple(v) for k, v in tflat.items()}
    sizes = {"dp_shard": 2, "tp": 1, "cp": 1}
    for spec in [(None, "tp"), ("dp_shard", None), (("dp_shard", "cp"), None, "tp"), ()]:
        assert tuple(tsh.canonicalize_spec(spec, sizes)) == tuple(
            jsh.canonicalize_spec(JP(*spec), sizes))


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = ParallelismConfig(dp_shard_size=2, tp_size=2).build_mesh(4)
    got = tsh.placements(tsh.PartitionSpec(("dp_shard", "tp"), None), mesh)
    assert got == [Replicate(), Replicate(), Shard(0), Replicate(), Replicate(), Shard(0),
                   Replicate()]
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements(tsh.PartitionSpec(("tp", "dp_shard")), mesh)


def test_fused_zero1_self_check_in_one_process():
    """The fused update's own check, as ``make doctor`` runs the JAX one: a
    fused AdamW step equals the plain one on the same gradients."""
    from accelerate_tpu_torch.parallel import weight_update

    got = weight_update.self_check()
    assert got["parity_max_abs_delta"] <= 1e-7
    assert got["num_buckets"] == 2 and got["plan_collective_bytes"] == (64 * 32 + 32 * 8) * 4
    assert got["opt_state_shard_fraction"] == 1.0
