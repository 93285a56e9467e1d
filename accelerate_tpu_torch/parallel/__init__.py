"""Parallel layers of the port: the MoE FFN (:mod:`.moe`), the sharding
plan and the collectives of a sharded step (:mod:`.sharding`), and the
fused ZeRO-1 update (:mod:`.weight_update`)."""

from .moe import init_moe_ffn, moe_ffn, moe_shard_rules
from .sharding import (
    PartitionSpec,
    ShardingPlan,
    ShardingRules,
    infer_param_specs,
    llama_tp_rules,
    make_sharding_plan,
)

__all__ = [
    "PartitionSpec",
    "ShardingPlan",
    "ShardingRules",
    "infer_param_specs",
    "init_moe_ffn",
    "llama_tp_rules",
    "make_sharding_plan",
    "moe_ffn",
    "moe_shard_rules",
]
