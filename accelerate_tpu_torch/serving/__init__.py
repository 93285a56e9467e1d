"""Serving: the port of ``accelerate_tpu.serving``.

- :mod:`.kv_pager`, :mod:`.scheduler`, :mod:`.buckets` and :mod:`.engine`
  — continuous batching over a paged KV cache (the paged attention
  kernels behind ``ops.flash_attention``);
- :mod:`.replica` — one warmed engine per unit of failure, in a thread or
  a child process, streaming per-step token progress;
- :mod:`.router` + :mod:`.admission` — health-checked
  least-outstanding-tokens dispatch over N replicas, exactly-once
  token-exact failover, self-heal, token-bucket admission, priority
  shedding and deadlines;
- :mod:`.disagg` + :mod:`.autoscaler` — disaggregated prefill/decode
  joined by a content-addressed KV handoff, two-tier dispatch, and the
  SLO-driven decode-tier autoscaler;
- :mod:`.canary` — bitwise golden probes from the single-stream
  reference, injected by the router.
"""

from .admission import (
    PRIORITY_BATCH,
    PRIORITY_INTERACTIVE,
    AdmissionController,
    AdmissionVerdict,
    TokenBucket,
)
from .autoscaler import AutoscalerPolicy, lattice_fns
from .buckets import BucketLattice
from .canary import CanaryGolden, CanaryProbe, precompute_goldens
from .disagg import (
    DecodeEngine,
    DisaggRouter,
    KVHandoff,
    KVTransport,
    LocalBlockCopyTransport,
    PrefillEngine,
)
from .engine import ServingEngine, paged_forward
from .kv_pager import (
    NULL_BLOCK,
    BlockAllocator,
    BlockAllocatorError,
    BlockPoolExhausted,
    PrefixAllocation,
    PrefixPlan,
    init_block_pool,
    paged_attention,
)
from .replica import LocalReplica, ProcessReplica, ReplicaSpec, ReplicaState
from .router import RouterRequest, RouterRequestStatus, ServingRouter
from .scheduler import Request, RequestStatus, Scheduler, SchedulingError

__all__ = [
    "BucketLattice",
    "ServingEngine",
    "paged_forward",
    "NULL_BLOCK",
    "BlockAllocator",
    "BlockAllocatorError",
    "BlockPoolExhausted",
    "init_block_pool",
    "paged_attention",
    "PrefixPlan",
    "PrefixAllocation",
    "Request",
    "RequestStatus",
    "Scheduler",
    "SchedulingError",
    "PRIORITY_INTERACTIVE",
    "PRIORITY_BATCH",
    "TokenBucket",
    "AdmissionVerdict",
    "AdmissionController",
    "ReplicaState",
    "ReplicaSpec",
    "LocalReplica",
    "ProcessReplica",
    "RouterRequest",
    "RouterRequestStatus",
    "ServingRouter",
    "KVHandoff",
    "KVTransport",
    "LocalBlockCopyTransport",
    "PrefillEngine",
    "DecodeEngine",
    "DisaggRouter",
    "AutoscalerPolicy",
    "lattice_fns",
    "CanaryGolden",
    "CanaryProbe",
    "precompute_goldens",
]
