"""Photonic execution engine (counterpart of ``repro.exec``):

  * scheduler — per-layer {OS, IS, WS} x tiling search over the
    event-driven perf model, with a content-addressed plan cache (copied
    from the reference: plans are equal field for field);
  * executor  — runs each planned GEMM through the TAOM kernel (quantize
    -> kernel -> rescale), batch folded into the GEMM M axis, noise seeds
    folded per layer; ``compiled_forward`` is the pure forward
    (``forward_fn``) captured once per input shape in a CUDA graph and
    replayed (the reference jit-compiles it), and the serving hot path,
    ``compiled_logits``, the same without the per-GEMM fingerprints;
  * serving   — power-of-two batch buckets, zero padding, warmup that
    captures every bucket, a thread-safe micro-batcher, a data-parallel
    path over several device entries (bitwise equal to one device), and
    serving metrics including modeled joules per image;
  * report    — modeled latency/energy aggregated next to executed
    numerics, as JSON-safe dicts and markdown.
"""
from repro_torch.exec.executor import (ExecutionResult, LayerTrace,
                                       clear_compile_cache,
                                       compile_cache_stats, compiled_forward,
                                       compiled_logits, execute_cnn,
                                       forward_fn,
                                       lowering_fingerprint,
                                       plan_for_network, reference_forward,
                                       trace_count)
from repro_torch.exec.plan_cache import (GLOBAL_PLAN_CACHE, PlanCache,
                                         fingerprint)
from repro_torch.exec.report import (energy_summary, execution_summary,
                                     graph_summary, plan_summary, plan_table,
                                     plan_vs_fixed, render_report,
                                     save_summary, serving_summary,
                                     throughput_summary)
from repro_torch.exec.scheduler import (CnnPlan, FrozenCandidates, LayerPlan,
                                        TileChoice, plan_layer,
                                        schedule_buckets, schedule_cnn)
from repro_torch.exec.serving import (MicroBatcher, ServingEngine, bucket_for,
                                      power_of_two_buckets)

__all__ = [
    "CnnPlan", "FrozenCandidates", "LayerPlan", "TileChoice", "plan_layer",
    "schedule_cnn", "schedule_buckets",
    "ServingEngine", "MicroBatcher", "power_of_two_buckets", "bucket_for",
    "serving_summary",
    "PlanCache", "GLOBAL_PLAN_CACHE", "fingerprint",
    "ExecutionResult", "LayerTrace", "execute_cnn", "plan_for_network",
    "reference_forward", "compiled_forward", "compiled_logits",
    "forward_fn", "trace_count",
    "compile_cache_stats", "clear_compile_cache", "lowering_fingerprint",
    "plan_summary", "plan_table", "plan_vs_fixed", "execution_summary",
    "graph_summary", "render_report", "save_summary", "throughput_summary",
    "energy_summary",
]
