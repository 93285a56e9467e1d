"""Helpers of the port, exported where the JAX package's
``accelerate_tpu.utils`` exports them: the settings and plugin spellings
of :mod:`.dataclasses` and the environment helpers eagerly; the
collectives, RNG, modeling, offload, quantization, packing and
checkpoint-layout names lazily (module ``__getattr__``), because those
modules import the process state, which imports this package. The JAX
package's names the port does not have yet are listed, with the item that
ports them, in :mod:`.api_boundary`."""

from .dataclasses import (
    AORecipeKwargs,
    AutocastConfig,
    AutocastKwargs,
    CheckpointConfig,
    DDPCommunicationHookType,
    DataLoaderConfiguration,
    DeepSpeedPlugin,
    DeepSpeedSequenceParallelConfig,
    DistributedDataParallelKwargs,
    DistributedType,
    DummyOptim,
    DummyScheduler,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradScalerConfig,
    GradScalerKwargs,
    GradientAccumulationPlugin,
    HfDeepSpeedConfig,
    InitProcessGroupKwargs,
    KwargsHandler,
    LoggerType,
    MSAMPRecipeKwargs,
    MegatronLMPlugin,
    MixedPrecisionPolicy,
    PrecisionType,
    ProjectConfiguration,
    RNGType,
    SaveFormat,
    TERecipeKwargs,
    TorchContextParallelConfig,
    TorchTensorParallelConfig,
    TorchTensorParallelPlugin,
    deepspeed_required,
    disable_fsdp_ram_efficient_loading,
    enable_fsdp_ram_efficient_loading,
    get_active_deepspeed_plugin,
)
from .environment import (
    get_cpu_distributed_information,
    get_current_device_type,
    get_int_from_env,
    parse_choice_from_env,
    parse_flag_from_env,
    patch_environment,
    str_to_bool,
)

# name -> the module (relative to the port's root package) that defines it
_LAZY = {
    **dict.fromkeys((
        "CannotPadNestedTensorWarning", "DistributedOperationException", "TensorInformation",
        "avg_losses_across_data_parallel_group", "broadcast", "broadcast_object_list",
        "concatenate", "find_batch_size", "gather", "gather_across_data_parallel_groups",
        "gather_object", "get_data_structure", "ignorant_find_batch_size", "initialize_tensors",
        "is_tensor_information", "pad_across_processes", "pad_input_tensors",
        "recursively_apply", "reduce", "send_to_device", "slice_tensors", "stack_batches",
        "verify_operation"), "utils.operations"),
    **dict.fromkeys(("capture_rng_states", "restore_rng_states", "synchronize_rng_state",
                     "synchronize_rng_states"), "utils.random"),
    "set_seed": "accelerator",
    **dict.fromkeys((
        "abstract_params", "calculate_maximum_sizes", "check_device_map",
        "check_tied_parameters_in_config", "check_tied_parameters_on_same_device",
        "clean_device_map", "compute_module_sizes", "compute_parameter_sizes",
        "convert_file_size_to_int", "dtype_byte_size", "ensure_weights_retied",
        "extract_submodules_state_dict", "find_tied_parameters", "get_balanced_memory",
        "get_max_layer_size", "get_max_memory", "infer_auto_device_map",
        "load_checkpoint_in_params", "load_state_dict", "named_parameters", "retie_parameters",
        "total_byte_size", "unflatten_parameters"), "utils.modeling"),
    **dict.fromkeys((
        "OffloadedWeightsLoader", "PrefixedDataset", "load_offload_index",
        "load_offloaded_weight", "offload_state_dict", "offload_weight", "save_offload_index"),
        "utils.offload"),
    **dict.fromkeys(("QuantizationConfig", "QuantizedArray", "quantize_params",
                     "dequantize_params"), "ops.quantization"),
    "load_and_quantize_model": "utils.quantization",
    **dict.fromkeys(("clean_state_dict_for_safetensors", "load", "save"), "utils.other"),
    **dict.fromkeys(("pack_sequences", "unpack_logits"), "utils.packing"),
    **dict.fromkeys((
        "MODEL_NAME", "OPTIMIZER_NAME", "SCHEDULER_NAME", "SAMPLER_NAME", "RNG_NAME",
        "SAFE_MODEL_NAME", "SAFE_WEIGHTS_NAME", "SAFE_WEIGHTS_INDEX_NAME",
        "SAFE_WEIGHTS_PATTERN_NAME", "WEIGHTS_NAME", "WEIGHTS_INDEX_NAME",
        "WEIGHTS_PATTERN_NAME", "RNG_STATE_NAME", "SCALER_NAME", "PROFILE_PATTERN_NAME",
        "load_checkpoint_in_model"), "checkpointing"),
    **dict.fromkeys(("save_fsdp_model", "load_fsdp_model", "save_fsdp_optimizer",
                     "load_fsdp_optimizer"), "sharded_checkpoint"),
    "ParallelismConfig": "parallelism_config",
}
# the JAX package's other spellings of a name the port defines
_ALIASES = {"BnbQuantizationConfig": ("ops.quantization", "QuantizationConfig"),
            "merge_fsdp_weights": ("sharded_checkpoint", "merge_sharded_checkpoint")}


def wait_for_everyone():
    """Block until every process reaches this point (the state is made at
    call time: making it starts the process group)."""
    from ..state import PartialState

    return PartialState().wait_for_everyone()


def __getattr__(name):
    import importlib

    if name in _LAZY:
        module, attr = _LAZY[name], name
    elif name in _ALIASES:
        module, attr = _ALIASES[name]
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.{module}"), attr)


__all__ = sorted({n for n, v in globals().items()
                  if not n.startswith("_") and not isinstance(v, type(__import__("os")))}
                 | set(_LAZY) | set(_ALIASES))


def __dir__():
    return sorted(set(globals()) | set(_LAZY) | set(_ALIASES))
