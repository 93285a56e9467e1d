"""Helpers of the port. The plugin and kwargs-handler spellings are
exported here, as the JAX package's ``accelerate_tpu.utils`` exports
them."""

from .dataclasses import (
    AORecipeKwargs,
    DDPCommunicationHookType,
    DistributedDataParallelKwargs,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    HfDeepSpeedConfig,
    InitProcessGroupKwargs,
    KwargsHandler,
    MegatronLMPlugin,
    MSAMPRecipeKwargs,
    TERecipeKwargs,
    deepspeed_required,
    disable_fsdp_ram_efficient_loading,
    enable_fsdp_ram_efficient_loading,
    get_active_deepspeed_plugin,
)

__all__ = [
    "AORecipeKwargs",
    "DDPCommunicationHookType",
    "DistributedDataParallelKwargs",
    "FP8RecipeKwargs",
    "FullyShardedDataParallelPlugin",
    "HfDeepSpeedConfig",
    "InitProcessGroupKwargs",
    "KwargsHandler",
    "MSAMPRecipeKwargs",
    "MegatronLMPlugin",
    "TERecipeKwargs",
    "deepspeed_required",
    "disable_fsdp_ram_efficient_loading",
    "enable_fsdp_ram_efficient_loading",
    "get_active_deepspeed_plugin",
]
