"""Continuous-batching LM serving on the refcounted, versioned page pool —
the layered stack (scheduler policy / kv-manager mechanics / fused runner)
behind the ``PagedServingEngine`` facade."""

from .draft import NGramDrafter
from .engine import PagedServingEngine
from .kv_manager import DeviceStepState, KVCacheManager
from .overload import (DEFAULT_CLASSES, ClassQueues, DegradationLadder,
                       LadderConfig, RequestClass, VICTIM_POLICIES)
from .paged_decode import fused_decode_step, kv_storage_init, paged_decode_step
from .runner import ModelRunner, StepResult
from .scheduler import PrefixIndex, Request, Scheduler, required_pages_per_seq
from .stats import ClassStats, EngineStats, LatencyReservoir, aggregate_stats

__all__ = ["PagedServingEngine", "Request", "NGramDrafter",
           "EngineStats", "aggregate_stats", "Scheduler", "PrefixIndex",
           "KVCacheManager", "DeviceStepState", "ModelRunner", "StepResult",
           "required_pages_per_seq",
           "paged_decode_step", "fused_decode_step", "kv_storage_init",
           "RequestClass", "DEFAULT_CLASSES", "ClassQueues",
           "DegradationLadder", "LadderConfig", "VICTIM_POLICIES",
           "ClassStats", "LatencyReservoir"]
