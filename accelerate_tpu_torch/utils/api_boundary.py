"""The port's API boundary against the JAX package: every public name of
``accelerate_tpu`` (its ``__all__`` and the names its ``__getattr__``
serves lazily) and of its subpackages ``utils``, ``parallel``, ``models``,
``ops``, ``telemetry`` and ``resilience`` either resolves from the port's
module of the same name or is listed here with the ROADMAP.md Queue A item
that ports it, or as ``"no counterpart: <why>"`` for a name that only
means something beside JAX or a TPU. ``tests/test_torch_api_boundary.py``
holds each set to the JAX package's names, with no overlap, so a name
cannot go missing unnoticed. ``accelerate_tpu.utils.jax_compat`` (JAX
version shims) has no counterpart.
"""

from __future__ import annotations

__all__ = ["LATER_ITEMS", "SUBPACKAGE_LATER_ITEMS"]

_MEMORY = "12d: the command line and small utilities (utils/memory.py)"
_LAUNCH = "12d: the command line and small utilities (launchers.py, utils/launch.py)"
_CONSOLE = "12d: the command line and small utilities (utils/rich.py, utils/tqdm.py)"
_IMPORTS = "12d: the command line and small utilities (utils/imports.py, utils/versions.py)"
_OTHER = "12d: the command line and small utilities (utils/other.py, utils/environment.py)"
_SETTINGS = "12d: the command line and small utilities (Accelerator.__init__'s configs, CLI enums)"
_PIPELINE = "11b: pipelines, local SGD, LOMO on other meshes (parallel/pipeline.py)"
_TORCH_MODULES = "13: the torch-module helpers of utils/modeling.py (bridge/)"
_XLA_OFFLOAD = ("13: XLA memory-kind offload; the port's counterpart is "
                "prepare_train_step(offload_optimizer=)")
_TELEMETRY = "12a: telemetry core and the profiler (telemetry/)"
_RESILIENCE = "12b: resilience and chaos (resilience/)"
_JAX_ONLY = "no counterpart: a probe of JAX, its libraries or a TPU"


def _items(item: str, *names: str) -> dict:
    return dict.fromkeys(names, item)


#: public name of ``accelerate_tpu`` the port does not resolve yet -> "<Queue
#: A item>: <what it belongs to>"
LATER_ITEMS: "dict[str, str]" = {
    "LocalSGD": "11b: pipelines, local SGD, LOMO on other meshes (local_sgd.py)",
    "ProfileKwargs": "12a: telemetry core and the profiler (Accelerator.profile)",
    **_items(_MEMORY, "clear_device_cache", "find_executable_batch_size", "release_memory"),
    **_items(_LAUNCH, "debug_launcher", "notebook_launcher"),
    **_items(_CONSOLE, "get_console", "is_rich_available", "rich", "rich_print", "tqdm"),
    **_items(_PIPELINE, "prepare_pipeline", "prepare_pippy"),
}

#: per subpackage, its public names the port's module of the same name does
#: not resolve yet -> "<Queue A item>: <what it belongs to>" or "no
#: counterpart: <why>"
SUBPACKAGE_LATER_ITEMS: "dict[str, dict[str, str]]" = {
    "utils": {
        **_items(_JAX_ONLY, "is_chex_available", "is_flax_available", "is_jax_version",
                 "is_optax_available", "is_orbax_available", "is_pallas_available",
                 "is_torch_xla_available", "is_tpu_available", "prepare_tpu"),
        "EXCLUDED_REFERENCE_UTILS": ("no counterpart: the JAX package's own table of the "
                                     "reference's names it leaves out; the port's boundary is "
                                     "this module"),
        **_items("12a: telemetry core and the profiler (Accelerator.profile)", "ProfileConfig",
                 "ProfileKwargs"),
        **_items(_SETTINGS, "ComputeEnvironment", "CustomDtype", "DynamoBackend", "JitConfig",
                 "SageMakerDistributedType", "TorchDynamoPlugin", "WatchdogConfig",
                 "add_model_config_to_megatron_parser"),
        **_items(_LAUNCH, "PrepareForLaunch", "prepare_multi_gpu_env",
                 "prepare_simple_launcher_cmd_env", "write_basic_config"),
        **_items(_MEMORY, "clear_device_cache", "find_executable_batch_size", "release_memory",
                 "should_reduce_batch_size"),
        **_items(_CONSOLE, "tqdm"),
        **_items(_OTHER, "are_libraries_initialized", "check_os_kernel", "clear_environment",
                 "compile_regions", "convert_bytes", "convert_dict_to_env_variables",
                 "convert_outputs_to_fp32", "convert_to_fp32", "extract_model_from_parallel",
                 "find_device", "get_pretty_name", "has_compiled_regions", "honor_type",
                 "is_compiled_module", "is_namedtuple", "is_port_in_use", "is_torch_tensor",
                 "listify", "merge_dicts", "purge_accelerate_environment", "recursive_getattr",
                 "set_numa_affinity"),
        **_items(_IMPORTS, "compare_versions", "imports", "is_4bit_bnb_available",
                 "is_8bit_bnb_available", "is_aim_available", "is_bf16_available",
                 "is_bitsandbytes_multi_backend_available", "is_bnb_available",
                 "is_boto3_available", "is_clearml_available", "is_comet_ml_available",
                 "is_cpu_only", "is_cuda_available", "is_datasets_available",
                 "is_deepspeed_available", "is_dvclive_available", "is_fp16_available",
                 "is_fp8_available", "is_gpu_available", "is_habana_gaudi1", "is_hpu_available",
                 "is_import_timer_available", "is_lomo_available", "is_matplotlib_available",
                 "is_megatron_lm_available", "is_mlflow_available", "is_mlu_available",
                 "is_mps_available", "is_msamp_available", "is_multihost", "is_musa_available",
                 "is_npu_available", "is_pandas_available", "is_peft_available", "is_peft_model",
                 "is_pippy_available", "is_pynvml_available", "is_pytest_available",
                 "is_rich_available", "is_safetensors_available", "is_sagemaker_available",
                 "is_schedulefree_available", "is_sdaa_available", "is_swanlab_available",
                 "is_tensorboard_available", "is_timm_available", "is_torch_available",
                 "is_torch_version", "is_torchao_available", "is_torchdata_available",
                 "is_torchdata_stateful_dataloader_available", "is_torchvision_available",
                 "is_tqdm_available", "is_trackio_available", "is_transformer_engine_available",
                 "is_transformer_engine_mxfp8_available", "is_transformers_available",
                 "is_triton_available", "is_wandb_available", "is_weights_only_available",
                 "is_xccl_available", "is_xpu_available", "model_has_dtensor",
                 "torchao_required", "versions"),
        **_items(_TORCH_MODULES, "align_module_device", "copy_tensor_to_devices",
                 "filter_first_and_last_linear_layers", "get_fsdp2_grad_scaler",
                 "get_grad_scaler", "get_mixed_precision_context_manager",
                 "get_module_children_bottom_up", "has_4bit_bnb_layers", "has_ao_layers",
                 "has_offloaded_params", "has_transformer_engine_layers", "id_tensor_storage",
                 "load_offloaded_weights", "named_module_tensors", "set_module_tensor_to_device"),
    },
    "parallel": {
        **_items(_PIPELINE, "make_pipeline_forward", "make_pipeline_train_step_1f1b",
                 "merge_microbatches", "prepare_pipeline", "split_into_stages",
                 "split_microbatches"),
        **_items(_XLA_OFFLOAD, "host_memory_kind", "host_offload_supported",
                 "make_host_offloaded_step", "offload_memory_kinds", "offload_to_host",
                 "offload_tree_shardings"),
    },
    "models": {},
    "ops": {"flash_kernel_mode": ("no counterpart: the JAX package's switch between its Pallas "
                                  "kernel and interpret mode; the port's wrappers pick by the "
                                  "tensor's device")},
    "telemetry": _items(
        _TELEMETRY, "CompiledCost", "EventLog", "FlightRecorder", "HardwarePeaks", "Histogram",
        "MemoryMonitor", "MetricsRegistry", "RecompileWatcher", "StepTelemetry",
        "TELEMETRY_DIR_ENV_VAR", "TELEMETRY_ENV_VAR", "TELEMETRY_SCHEMA_VERSION", "TraceContext",
        "TraceWindows", "Watchdog", "capture_compiled", "counter", "device_memory_stats",
        "disable", "emit", "enable", "enabled_from_env", "flight_recorder", "gauge",
        "get_event_log", "goodput", "hard_flush", "host_memory_bytes", "is_enabled",
        "live_array_bytes", "lm_train_mfu", "maybe_enable_from_env", "metrics",
        "mirror_to_trackers", "peaks_for_device", "perf", "record_data_wait", "regress",
        "set_step", "span", "summarize_trace", "summary_metrics", "tracing", "watchdog",
        "xplane"),
    "resilience": _items(
        _RESILIENCE, "ChaosFaultError", "ChaosSchedule", "CohortSpec", "Fault", "MembershipError",
        "RestartPolicy", "Supervisor", "announce_membership", "classify_exit",
        "current_generation", "load_cohort_spec", "maybe_arm_from_env", "maybe_inject",
        "negotiate_membership", "replan_data_assignment", "supervise_command"),
}
