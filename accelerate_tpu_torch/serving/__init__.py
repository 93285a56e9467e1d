from .buckets import BucketLattice
from .engine import ServingEngine, paged_forward
from .kv_pager import NULL_BLOCK, BlockAllocator, init_block_pool
from .scheduler import Request, RequestStatus, Scheduler

__all__ = [
    "NULL_BLOCK",
    "BlockAllocator",
    "BucketLattice",
    "Request",
    "RequestStatus",
    "Scheduler",
    "ServingEngine",
    "init_block_pool",
    "paged_forward",
]
