"""Helpers of the port. The plugin and kwargs-handler spellings are
exported here, as the JAX package's ``accelerate_tpu.utils`` exports
them."""

from .dataclasses import (
    DDPCommunicationHookType,
    DistributedDataParallelKwargs,
    FullyShardedDataParallelPlugin,
    HfDeepSpeedConfig,
    InitProcessGroupKwargs,
    KwargsHandler,
    MegatronLMPlugin,
    deepspeed_required,
    disable_fsdp_ram_efficient_loading,
    enable_fsdp_ram_efficient_loading,
    get_active_deepspeed_plugin,
)

__all__ = [
    "DDPCommunicationHookType",
    "DistributedDataParallelKwargs",
    "FullyShardedDataParallelPlugin",
    "HfDeepSpeedConfig",
    "InitProcessGroupKwargs",
    "KwargsHandler",
    "MegatronLMPlugin",
    "deepspeed_required",
    "disable_fsdp_ram_efficient_loading",
    "enable_fsdp_ram_efficient_loading",
    "get_active_deepspeed_plugin",
]
