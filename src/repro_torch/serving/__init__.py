"""Continuous-batching LM serving on the refcounted, versioned page pool —
the layered stack (scheduler policy / kv-manager mechanics / fused runner)
behind the ``PagedServingEngine`` facade, with data-parallel multi-pool
serving on top (``DataParallelEngine``)."""

from .draft import NGramDrafter
from .engine import PagedServingEngine
from .kv_manager import DeviceStepState, KVCacheManager
from .overload import (DEFAULT_CLASSES, ClassQueues, DegradationLadder,
                       LadderConfig, RequestClass, VICTIM_POLICIES)
from .paged_decode import fused_decode_step, kv_storage_init, paged_decode_step
from .parallel import DataParallelEngine, ReplicaStalled, WatchdogConfig
from .runner import ModelRunner, StepResult
from .scheduler import PrefixIndex, Request, Scheduler, required_pages_per_seq
from .stats import ClassStats, EngineStats, LatencyReservoir, aggregate_stats
from .traffic import (TraceEvent, dump_trace, load_trace, replay_arrivals,
                      synthesize_trace)

__all__ = ["PagedServingEngine", "DataParallelEngine", "WatchdogConfig",
           "ReplicaStalled", "Request", "NGramDrafter",
           "EngineStats", "aggregate_stats", "Scheduler", "PrefixIndex",
           "KVCacheManager", "DeviceStepState", "ModelRunner", "StepResult",
           "required_pages_per_seq",
           "paged_decode_step", "fused_decode_step", "kv_storage_init",
           "RequestClass", "DEFAULT_CLASSES", "ClassQueues",
           "DegradationLadder", "LadderConfig", "VICTIM_POLICIES",
           "ClassStats", "LatencyReservoir",
           "TraceEvent", "synthesize_trace", "dump_trace", "load_trace",
           "replay_arrivals"]
