"""Parallel layers of the port: the MoE FFN (:mod:`.moe`). The mesh and
its sharding rules are not ported yet (ROADMAP.md Queue A item 6)."""

from .moe import init_moe_ffn, moe_ffn, moe_shard_rules

__all__ = ["init_moe_ffn", "moe_ffn", "moe_shard_rules"]
