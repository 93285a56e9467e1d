"""Parallel layers of the port: the MoE FFN (:mod:`.moe`), the sharding
plan and the collectives of a sharded step (:mod:`.sharding`), the fused
ZeRO-1 update (:mod:`.weight_update`), and context and sequence parallel
attention (:mod:`.long_context`)."""

from .long_context import make_context_parallel_attention, sequence_parallel_attention
from .moe import init_moe_ffn, moe_ffn, moe_shard_rules
from .sharding import (
    FSDP_AXES,
    PartitionSpec,
    ShardingPlan,
    ShardingRules,
    canonicalize_spec,
    infer_param_specs,
    llama_tp_rules,
    make_sharding_plan,
    replicate,
    shard_like_params,
    shard_params,
    tree_specs_like,
    zero1_state_specs,
)
from .weight_update import (
    FusedZero1Incompatible,
    Zero1BucketPlan,
    build_bucket_plan,
    init_bucketed_opt_state,
    make_fused_zero1_update,
)

__all__ = [
    "FSDP_AXES",
    "FusedZero1Incompatible",
    "PartitionSpec",
    "ShardingPlan",
    "ShardingRules",
    "Zero1BucketPlan",
    "build_bucket_plan",
    "canonicalize_spec",
    "infer_param_specs",
    "init_bucketed_opt_state",
    "init_moe_ffn",
    "llama_tp_rules",
    "make_context_parallel_attention",
    "make_fused_zero1_update",
    "make_sharding_plan",
    "moe_ffn",
    "moe_shard_rules",
    "replicate",
    "sequence_parallel_attention",
    "shard_like_params",
    "shard_params",
    "tree_specs_like",
    "zero1_state_specs",
]
