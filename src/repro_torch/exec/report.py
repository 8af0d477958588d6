"""Report layer: plan + execution summaries for humans and for the
benchmark harness (PyTorch counterpart of ``repro.exec.report``, kept as
the port's own copy).

Aggregates the scheduler's per-layer modeled latency/energy next to the
executor's actual numerics, renders markdown and emits JSON-safe dicts.
``save_summary`` writes only into the directory its caller names.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional

from repro_torch.core.types import Dataflow
from repro_torch.exec.executor import ExecutionResult
from repro_torch.exec.scheduler import CnnPlan
from repro_torch.models.lowering import OpGraph


def graph_summary(graph: OpGraph, name: str = "") -> dict:
    """JSON-safe structural summary of a lowered op graph (the zoo's
    networks): op histogram + GEMM-layer count, for reports/examples."""
    ops: Dict[str, int] = {}
    for n in graph.nodes:
        ops[n.op] = ops.get(n.op, 0) + 1
    return {
        "name": name,
        "n_nodes": len(graph.nodes),
        "n_gemm_layers": len(graph.gemm_nodes),
        "ops": ops,
        "output": graph.output.name,
    }


def plan_summary(plan: CnnPlan, name: str = "") -> dict:
    """JSON-safe summary of an auto-scheduled plan."""
    top = sorted(plan.layers, key=lambda p: -p.latency_s)[:5]
    return {
        "name": name,
        "backend": plan.acc.backend,
        "data_rate_gsps": plan.acc.data_rate_gsps,
        "batch": plan.batch,
        "objective": plan.objective,
        "n_layers": len(plan.layers),
        "dataflow_mix": plan.mix(),
        "fps": plan.fps,
        "fps_per_watt": plan.fps_per_watt,
        "latency_s": plan.latency_s,
        "energy_j": plan.result.energy_j,
        "cache_hits": plan.cache_hits,
        "cache_misses": plan.cache_misses,
        "top_layers": [
            {"name": p.name, "shape": [p.c, p.k, p.d],
             "dataflow": p.dataflow.value, "latency_s": p.latency_s,
             "share": p.latency_s / max(plan.latency_s, 1e-30)}
            for p in top],
    }


def plan_table(plan: CnnPlan, max_rows: int = 0) -> str:
    """Markdown per-layer table of an auto-scheduled plan."""
    rows = plan.layers[:max_rows] if max_rows else plan.layers
    total = max(plan.latency_s, 1e-30)
    lines = [
        "| layer | C | K | D | flow | tile (m,d) | latency | share |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for p in rows:
        lines.append(
            f"| {p.name} | {p.c} | {p.k} | {p.d} | {p.dataflow.value} | "
            f"{p.tile.block_m},{p.tile.block_d} | {p.latency_s:.3e} s | "
            f"{100 * p.latency_s / total:.1f}% |")
    if max_rows and len(plan.layers) > max_rows:
        lines.append(f"| ... {len(plan.layers) - max_rows} more | | | | | "
                     f"| | |")
    return "\n".join(lines)


def plan_vs_fixed(plan: CnnPlan, fixed: Dict[Dataflow, float]) -> dict:
    """Compare a plan's FPS against fixed-dataflow FPS numbers."""
    best_flow, best_fps = max(fixed.items(), key=lambda kv: kv[1])
    return {
        "auto_fps": plan.fps,
        "fixed_fps": {f.value: v for f, v in fixed.items()},
        "best_fixed_flow": best_flow.value,
        "best_fixed_fps": best_fps,
        "uplift": plan.fps / best_fps if best_fps > 0 else float("inf"),
    }


def execution_summary(res: ExecutionResult, name: str = "",
                      numerics: Optional[dict] = None) -> dict:
    """Modeled plan totals next to executed-numerics evidence."""
    energy = res.energy()
    out = {
        "name": name,
        "batch": res.plan.batch,
        "modeled_fps": res.plan.fps,
        "modeled_latency_s": res.plan.latency_s,
        "dataflow_mix": res.plan.mix(),
        "executed_energy_j": energy.energy_j,
        "executed_j_per_image": energy.j_per_image,
        "executed_fps_per_watt": energy.fps_per_watt,
        "energy_breakdown": {
            f: getattr(energy.breakdown, f)
            for f in ("laser", "dac", "adc", "tuning", "buffer",
                      "reduction", "static")},
        "layers": [
            {"name": t.name, "m": t.m, "k": t.k, "d": t.d,
             "dataflow": t.dataflow, "tile": [t.block_m, t.block_d],
             "latency_s": t.latency_s, "energy_j": t.energy_j,
             "executed_energy_j": t.executed_energy_j,
             "n_chunks": t.n_chunks,
             "adc_conversions": t.adc_conversions,
             "out_mean_abs": t.out_mean_abs}
            for t in res.traces],
    }
    if res.plan.op is not None:
        out["operating_point"] = res.plan.op.describe()
    if numerics:
        out["numerics"] = dict(numerics)
    return out


def throughput_summary(name: str, batch: int, compiled_ips: float,
                       eager_ips: float, modeled_fps: float,
                       extras: Optional[dict] = None) -> dict:
    """JSON-safe record of one compiled-vs-eager throughput measurement.

    ``*_ips`` are measured warm-call images/sec;
    ``modeled_fps`` is the photonic perf-model number for context (the
    two are different machines — never compare them directly).
    """
    out = {
        "kind": "throughput",
        "name": name,
        "batch": batch,
        "compiled_ips": compiled_ips,
        "eager_ips": eager_ips,
        "speedup": (compiled_ips / eager_ips) if eager_ips > 0
        else float("inf"),
        "modeled_fps": modeled_fps,
    }
    if extras:
        out.update(extras)
    return out


def serving_summary(name: str, batch_bucket: int, engine_stats: dict,
                    bucketed_ips: float, per_request_ips: float,
                    extras: Optional[dict] = None) -> dict:
    """JSON-safe record of one serving-engine measurement.

    ``bucketed_ips`` is the engine's sustained warm throughput for this
    cell; ``per_request_ips`` is the single-image-at-a-time baseline
    (batch-1 plan, one compiled call per image) the bucketed path is
    amortizing away.  ``engine_stats`` is ServingEngine.stats() — the
    padding/latency/cache evidence rides along verbatim.
    """
    out = {
        "kind": "serving",
        "name": name,
        "bucket": batch_bucket,
        "bucketed_ips": bucketed_ips,
        "per_request_ips": per_request_ips,
        "speedup": (bucketed_ips / per_request_ips) if per_request_ips > 0
        else float("inf"),
        "latency_p50_s": engine_stats.get("latency_p50_s"),
        "latency_p99_s": engine_stats.get("latency_p99_s"),
        "padding_fraction": engine_stats.get("padding_fraction"),
        "retraces_since_warmup": engine_stats.get("retraces_since_warmup"),
        "data_parallel": engine_stats.get("data_parallel"),
        "n_devices": engine_stats.get("n_devices"),
        "plan_cache": engine_stats.get("plan_cache"),
        "compile_cache": engine_stats.get("compile_cache"),
    }
    if extras:
        out.update(extras)
    return out


def energy_summary(name: str, op, executed, analytic,
                   extras: Optional[dict] = None) -> dict:
    """JSON-safe record of one executed-trace energy measurement.

    ``op`` is the OperatingPoint everything was derived from, ``executed``
    a core.hw.TraceEnergy from the executed plan, ``analytic`` the
    perf_model.InferenceResult predicted for the same network/hardware —
    the coherence evidence (their relative gap) rides along explicitly.
    """
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    return {
        "kind": "energy",
        "name": name,
        "operating_point": op.describe(),
        "batch": executed.batch,
        "executed_fps": executed.fps,
        "executed_fps_per_watt": executed.fps_per_watt,
        "executed_energy_j": executed.energy_j,
        "executed_j_per_image": executed.j_per_image,
        "executed_watts": executed.watts,
        "analytic_fps": analytic.fps,
        "analytic_fps_per_watt": analytic.fps_per_watt,
        "analytic_energy_j": analytic.energy_j,
        "fps_rel_gap": rel(executed.fps, analytic.fps),
        "fpsw_rel_gap": rel(executed.fps_per_watt, analytic.fps_per_watt),
        **({} if not extras else dict(extras)),
    }


def render_report(summaries: Iterable[dict]) -> str:
    """Markdown table over plan summaries (one row per CNN/config)."""
    lines = [
        "| cnn | backend | batch | fps | fps/W | mix (os/is/ws) | "
        "cache h/m |",
        "|---|---|---|---|---|---|---|",
    ]
    for s in summaries:
        mix = s["dataflow_mix"]
        lines.append(
            f"| {s['name']} | {s['backend']} | {s['batch']} | "
            f"{s['fps']:.1f} | {s['fps_per_watt']:.2f} | "
            f"{mix.get('os', 0)}/{mix.get('is', 0)}/{mix.get('ws', 0)} | "
            f"{s['cache_hits']}/{s['cache_misses']} |")
    return "\n".join(lines)


def save_summary(summary: dict, directory: str, filename: str) -> str:
    """Write a summary JSON under ``directory`` (created if missing)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, filename)
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=1, sort_keys=True)
    return path
