"""Serving layer of the port: the in-flight engine and its paged KV pool,
the bucketed path, and the fault injector that tests the engine's
recovery paths."""
from repro_torch.serving.bucketing import (Bucket, candidate_buckets,
                                           pick_bucket)
from repro_torch.serving.faults import (FaultInjector, FaultSpec,
                                        InjectedFault, parse_fault)
from repro_torch.serving.paged_kv import (RESERVED_BLOCK, BlockAllocator,
                                          blocks_needed)
from repro_torch.serving.session import (Request, RequestResult,
                                         RequestState, ServeSession,
                                         SessionStats)

__all__ = ["Bucket", "candidate_buckets", "pick_bucket", "FaultInjector",
           "FaultSpec", "InjectedFault", "parse_fault", "RESERVED_BLOCK",
           "BlockAllocator", "blocks_needed", "Request", "RequestResult",
           "RequestState", "ServeSession", "SessionStats"]
