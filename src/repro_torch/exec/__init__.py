"""Photonic execution engine (counterpart of ``repro.exec``):

  * scheduler — per-layer {OS, IS, WS} x tiling search over the
    event-driven perf model, with a content-addressed plan cache (copied
    from the reference: plans are equal field for field);
  * executor  — runs each planned GEMM through the TAOM kernel (quantize
    -> kernel -> rescale), batch folded into the GEMM M axis, noise seeds
    folded per layer;
  * serving   — power-of-two batch buckets, zero padding, warmup and
    serving metrics including modeled joules per image.
"""
from repro_torch.exec.executor import (ExecutionResult, LayerTrace,
                                       execute_cnn, plan_for_network,
                                       reference_forward)
from repro_torch.exec.plan_cache import (GLOBAL_PLAN_CACHE, PlanCache,
                                         fingerprint)
from repro_torch.exec.scheduler import (CnnPlan, FrozenCandidates, LayerPlan,
                                        TileChoice, plan_layer,
                                        schedule_buckets, schedule_cnn)
from repro_torch.exec.serving import (ServingEngine, bucket_for,
                                      power_of_two_buckets)

__all__ = [
    "CnnPlan", "FrozenCandidates", "LayerPlan", "TileChoice", "plan_layer",
    "schedule_cnn", "schedule_buckets",
    "ServingEngine", "power_of_two_buckets", "bucket_for",
    "PlanCache", "GLOBAL_PLAN_CACHE", "fingerprint",
    "ExecutionResult", "LayerTrace", "execute_cnn", "plan_for_network",
    "reference_forward",
]
