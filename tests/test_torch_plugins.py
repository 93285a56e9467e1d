"""The plugins (``FullyShardedDataParallelPlugin``, ``DeepSpeedPlugin``,
``MegatronLMPlugin``) and the DeepSpeed helpers against the JAX package's,
on the CPU: each field, the mesh sizes of ``to_parallelism_config``,
``.remat``, ``from_env``, ``hf_ds_config`` filled from the three templates
in ``examples/deepspeed_config_templates/``, the ``Accelerator``'s errors,
warnings and accumulation steps, and the plugin's ``gradient_clipping``
chained ahead of the optimizer, whose 3 AdamW steps of the tiny Llama give
JAX's losses within 1e-6 relative and params within 1e-5 relative L2 (f32
sums in another order, as ``test_torch_offload.py`` measures).
"""

import dataclasses
import json
import warnings
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.state import PartialState as JPartialState
from accelerate_tpu.utils import dataclasses as jdc
import accelerate_tpu_torch as tpt
from accelerate_tpu_torch import Accelerator, utils as tutils
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.optimizer import adamw
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import dataclasses as tdc
from accelerate_tpu_torch.utils.environment import patch_environment
from accelerate_tpu_torch.utils.modeling import named_parameters

TEMPLATES = sorted((Path(__file__).resolve().parent.parent / "examples"
                    / "deepspeed_config_templates").glob("*.json"))
PC_FIELDS = ("pp_size", "dp_replicate_size", "dp_shard_size", "cp_size", "sp_size", "tp_size",
             "ep_size")


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    for key in ("ACCELERATE_MIXED_PRECISION", "ACCELERATE_USE_DEEPSPEED",
                "ACCELERATE_GRADIENT_ACCUMULATION_STEPS", "FSDP_CPU_RAM_EFFICIENT_LOADING"):
        monkeypatch.delenv(key, raising=False)
    for reset in (lambda: AcceleratorState._reset_state(reset_partial_state=True),
                  GradientState._reset_state, JAcceleratorState._reset_state,
                  JGradientState._reset_state, JPartialState._reset_state):
        reset()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _sizes(pc) -> tuple:
    return tuple(getattr(pc, f) for f in PC_FIELDS)


def _same_outcome(make_ours, make_theirs):
    """Both construct, or both raise the same exception class; returns the
    pair (None, None) on a raise."""
    try:
        theirs = make_theirs()
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        with pytest.raises(type(e)):
            make_ours()
        return None, None
    return make_ours(), theirs


# -- FullyShardedDataParallelPlugin --

@pytest.mark.parametrize("strategy", ["FULL_SHARD", "SHARD_GRAD_OP", "NO_SHARD", "HYBRID_SHARD",
                                      1, 2, 3, 4, "ShardingStrategy.NO_SHARD", "shard_grad_op",
                                      0, 5, "ZERO_SHARD"])
def test_fsdp_plugin_strategies_match_jax(strategy):
    ours, theirs = _same_outcome(
        lambda: tdc.FullyShardedDataParallelPlugin(sharding_strategy=strategy),
        lambda: jdc.FullyShardedDataParallelPlugin(sharding_strategy=strategy))
    if ours is None:
        return
    assert _fields(ours) == _fields(theirs)
    for repl in (1, 2):
        o, t = _same_outcome(lambda: ours.to_parallelism_config(8, dp_replicate_size=repl),
                             lambda: theirs.to_parallelism_config(8, dp_replicate_size=repl))
        if o is not None:
            assert _sizes(o) == _sizes(t)


@pytest.mark.parametrize("flag,explicit", [(None, None), ("false", None), ("true", None),
                                           ("false", True), ("1", False)])
def test_fsdp_ram_efficient_loading_env_matches_jax(flag, explicit, monkeypatch):
    if flag is not None:
        monkeypatch.setenv("FSDP_CPU_RAM_EFFICIENT_LOADING", flag)
    kw = {} if explicit is None else {"cpu_ram_efficient_loading": explicit}
    assert (tdc.FullyShardedDataParallelPlugin(**kw).cpu_ram_efficient_loading
            == jdc.FullyShardedDataParallelPlugin(**kw).cpu_ram_efficient_loading)


def test_fsdp_ram_efficient_toggles_and_remat(monkeypatch):
    monkeypatch.delenv("FSDP_CPU_RAM_EFFICIENT_LOADING", raising=False)
    tutils.disable_fsdp_ram_efficient_loading()
    assert not tdc.FullyShardedDataParallelPlugin().cpu_ram_efficient_loading
    tutils.enable_fsdp_ram_efficient_loading()
    assert tdc.FullyShardedDataParallelPlugin().cpu_ram_efficient_loading
    for ckpt in (False, True):
        assert (tdc.FullyShardedDataParallelPlugin(activation_checkpointing=ckpt).remat
                == jdc.FullyShardedDataParallelPlugin(activation_checkpointing=ckpt).remat)
        assert (tdc.MegatronLMPlugin(recompute_activations=ckpt).remat
                == jdc.MegatronLMPlugin(recompute_activations=ckpt).remat)


# -- MegatronLMPlugin --

@pytest.mark.parametrize("kw", [{}, {"tp_degree": 2}, {"tp_degree": 2, "pp_degree": 2},
                                {"expert_model_parallel_size": 4, "context_parallel_size": 2},
                                {"sequence_parallelism": True, "tp_degree": 4}])
def test_megatron_plugin_matches_jax(kw):
    ours, theirs = tdc.MegatronLMPlugin(**kw), jdc.MegatronLMPlugin(**kw)
    assert _fields(ours) == _fields(theirs)
    assert _sizes(ours.to_parallelism_config()) == _sizes(theirs.to_parallelism_config())


# -- DeepSpeedPlugin and its helpers --

@pytest.mark.parametrize("template", TEMPLATES, ids=lambda p: p.stem)
def test_deepspeed_plugin_from_templates_matches_jax(template):
    cfg = json.loads(template.read_text())
    ours, theirs = tdc.DeepSpeedPlugin(hf_ds_config=cfg), jdc.DeepSpeedPlugin(hf_ds_config=cfg)
    assert _fields(ours) == _fields(theirs)
    assert ours.mixed_precision == theirs.mixed_precision
    assert ours.dummy_optim_kwargs() == theirs.dummy_optim_kwargs()
    assert ours.dummy_scheduler_kwargs() == theirs.dummy_scheduler_kwargs()
    assert _sizes(ours.to_parallelism_config(8)) == _sizes(theirs.to_parallelism_config(8))
    hf, jhf = tdc.HfDeepSpeedConfig(str(template)), jdc.HfDeepSpeedConfig(str(template))
    for probe in ("is_zero2", "is_zero3", "is_offload"):
        assert getattr(hf, probe)() == getattr(jhf, probe)()
    for key in ("zero_optimization.stage", "bf16.enabled", "optimizer.params.lr", "absent.key"):
        assert hf.get_value(key) == jhf.get_value(key)
        assert hf.is_true(key) == jhf.is_true(key) and hf.is_false(key) == jhf.is_false(key)


@pytest.mark.parametrize("kw", [{"zero_stage": 3}, {"zero_stage": 1, "gradient_clipping": 0.5},
                                {"offload_optimizer_device": "nvme"}, {"zero_stage": 4},
                                {"gradient_accumulation_steps": 8}])
def test_explicit_value_beats_the_ds_config_as_jax(kw):
    cfg = {"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
           "gradient_clipping": "auto", "gradient_accumulation_steps": 4}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ours, theirs = _same_outcome(lambda: tdc.DeepSpeedPlugin(hf_ds_config=cfg, **kw),
                                     lambda: jdc.DeepSpeedPlugin(hf_ds_config=cfg, **kw))
    if ours is None:
        return
    assert _fields(ours) == _fields(theirs)
    messages = [str(w.message) for w in caught if "explicit" in str(w.message)]
    assert len(messages) % 2 == 0 and messages[:len(messages) // 2] == messages[
        len(messages) // 2:]


def test_deepspeed_from_env_matches_jax(tmp_path):
    path = tmp_path / "ds.json"
    path.write_text(TEMPLATES[-1].read_text())
    env = {"ACCELERATE_DEEPSPEED_ZERO_STAGE": "1", "ACCELERATE_GRADIENT_CLIPPING": "0.7",
           "ACCELERATE_DEEPSPEED_OFFLOAD_OPTIMIZER_DEVICE": "cpu",
           "ACCELERATE_DEEPSPEED_OFFLOAD_PARAM_DEVICE": "none",
           "ACCELERATE_DEEPSPEED_CONFIG_FILE": str(path),
           "ACCELERATE_GRADIENT_ACCUMULATION_STEPS": "2"}
    with patch_environment(**env):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert _fields(tdc.DeepSpeedPlugin.from_env()) == _fields(
                jdc.DeepSpeedPlugin.from_env())
    with patch_environment(ACCELERATE_DEEPSPEED_ZERO_STAGE="auto"):
        assert _fields(tdc.DeepSpeedPlugin.from_env()) == _fields(jdc.DeepSpeedPlugin.from_env())


def test_active_plugin_helpers_match_jax():
    class Holder:
        def __init__(self, plugin):
            self.deepspeed_plugin = plugin

        @tdc.deepspeed_required
        def ours(self):
            return "ran"

    plugin = tdc.DeepSpeedPlugin()
    assert tdc.get_active_deepspeed_plugin(Holder(plugin)) is plugin
    assert Holder(plugin).ours() == "ran"
    for holder in (Holder(None), Holder({"a": plugin})):
        with pytest.raises(ValueError):
            tdc.get_active_deepspeed_plugin(holder)
        with pytest.raises(ValueError):
            jdc.get_active_deepspeed_plugin(holder)
    with pytest.raises(ValueError):
        Holder(None).ours()
    plugin.selected = True
    assert tdc.get_active_deepspeed_plugin(Holder({"a": plugin})) is plugin
    for name in ("DDPCommunicationHookType", "DistributedDataParallelKwargs",
                 "FullyShardedDataParallelPlugin", "InitProcessGroupKwargs", "MegatronLMPlugin"):
        assert hasattr(tpt, name)


# -- the Accelerator --

def _both(kw_ours: dict, kw_theirs: dict):
    """Construct both Accelerators on the CPU; the same exception class when
    JAX's raises. Returns the pair or (None, None)."""
    def theirs():
        for cls in (JAcceleratorState, JGradientState, JPartialState):
            cls._reset_state()
        return JAccelerator(cpu=True, **kw_theirs)

    def ours():
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        return Accelerator(cpu=True, **kw_ours)

    return _same_outcome(ours, theirs)


def _plugins(**spec):
    """The same plugins in each package: ``{name: (kind, kwargs)}``."""
    ours, theirs = {}, {}
    for arg, (kind, kw) in spec.items():
        ours[arg] = getattr(tdc, kind)(**kw)
        theirs[arg] = getattr(jdc, kind)(**kw)
    return ours, theirs


@pytest.mark.parametrize("spec", [
    dict(fsdp_plugin=("FullyShardedDataParallelPlugin", {}),
         deepspeed_plugin=("DeepSpeedPlugin", {})),
    dict(megatron_lm_plugin=("MegatronLMPlugin", {}), deepspeed_plugin=("DeepSpeedPlugin", {})),
    dict(megatron_lm_plugin=("MegatronLMPlugin", {}), parallelism_config=None),
])
def test_accelerator_refuses_plugin_combinations_as_jax(spec):
    with_pc = "parallelism_config" in spec
    spec = {k: v for k, v in spec.items() if v is not None}
    ours, theirs = _plugins(**spec)
    if with_pc:
        from accelerate_tpu.parallelism_config import ParallelismConfig as JPC

        ours["parallelism_config"] = tpt.ParallelismConfig()
        theirs["parallelism_config"] = JPC()
    assert _both(ours, theirs) == (None, None)


@pytest.mark.parametrize("kw,ga,want", [
    (dict(deepspeed_plugin=("DeepSpeedPlugin", {"gradient_accumulation_steps": 4})), 1, 4),
    (dict(deepspeed_plugin=("DeepSpeedPlugin", {"gradient_accumulation_steps": 4})), 2, 2),
    (dict(megatron_lm_plugin=("MegatronLMPlugin", {"num_micro_batches": 3})), 1, 3),
    (dict(fsdp_plugin=("FullyShardedDataParallelPlugin", {})), 1, 1),
])
def test_accumulation_steps_from_plugins_match_jax(kw, ga, want):
    ours, theirs = _plugins(**kw)
    o, t = _both(dict(ours, gradient_accumulation_steps=ga),
                 dict(theirs, gradient_accumulation_steps=ga))
    assert o.gradient_accumulation_steps == t.gradient_accumulation_steps == want


def test_ds_precision_beats_the_launcher_and_a_constructor_conflict_raises(monkeypatch):
    cfg = {"fp16": {"enabled": True}}
    ours, theirs = _plugins(deepspeed_plugin=("DeepSpeedPlugin", {"hf_ds_config": cfg}))
    o, t = _both(ours, theirs)
    assert o.mixed_precision == str(t.mixed_precision) == "fp16"
    monkeypatch.setenv("ACCELERATE_MIXED_PRECISION", "bf16")
    with pytest.warns(UserWarning, match="ds config wins"):
        AcceleratorState._reset_state(reset_partial_state=True)
        assert Accelerator(cpu=True, **ours).mixed_precision == "fp16"
    assert _both(dict(ours, mixed_precision="bf16"),
                 dict(theirs, mixed_precision="bf16")) == (None, None)


def test_use_deepspeed_env_builds_the_plugin_as_jax(monkeypatch):
    monkeypatch.setenv("ACCELERATE_USE_DEEPSPEED", "true")
    monkeypatch.setenv("ACCELERATE_DEEPSPEED_ZERO_STAGE", "1")
    monkeypatch.setenv("ACCELERATE_GRADIENT_CLIPPING", "0.25")
    o, t = _both({}, {})
    assert _fields(o.deepspeed_plugin) == _fields(t.deepspeed_plugin)
    assert o._plugin_grad_clip == t._plugin_grad_clip == 0.25


def test_plugin_gradient_clipping_gives_jax_losses():
    jcfg = jt.LlamaConfig.tiny()
    tcfg = tt.LlamaConfig.tiny()
    jp = jax.tree_util.tree_map(np.asarray, jt.init_llama(jcfg, jax.random.PRNGKey(0)))
    ids = np.random.default_rng(0).integers(1, jcfg.vocab_size, (3, 4, 64)).astype(np.int32)
    ours, theirs = _plugins(deepspeed_plugin=("DeepSpeedPlugin",
                                              {"zero_stage": 0, "gradient_clipping": 0.1}))
    o, t = _both(ours, theirs)
    jparams, jopt = t.prepare(jax.tree_util.tree_map(np.array, jp), optax.adamw(1e-3))
    jstep = t.prepare_train_step(lambda p, b: jt.llama_loss(p, b, jcfg), compute_grad_norm=True)
    params, opt = o.prepare(params_from_numpy(jp, device="cpu"), adamw(1e-3))
    step = o.prepare_train_step(lambda p, b: tt.llama_loss(p, b, tcfg), compute_grad_norm=True)
    state, jl, tl, norms = jopt.opt_state, [], [], []
    for k in range(3):
        jparams, state, jm = jstep(jparams, state, {"input_ids": ids[k]})
        params, _, m = step(params, opt.opt_state, {"input_ids": torch.from_numpy(ids[k])})
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    assert min(norms) > 0.1  # the clip acted on every step
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    want = named_parameters(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                              device="cpu"))
    for k, v in named_parameters(params).items():
        a, b = v.detach().double(), want[k].detach().double()
        assert float(torch.linalg.norm(a - b) / torch.linalg.norm(b)) <= 1e-5, k
