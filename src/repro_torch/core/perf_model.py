"""Event-driven system-level performance model (paper §6, Figs. 11-14).

Models a whole accelerator (Fig. 10: tiles of 4 DPUs, unified buffer,
H-tree) inferring a CNN: every conv layer's GEMM is scheduled onto the
DPUs under a chosen dataflow, and latency/energy are accumulated from the
schedule counts of core.dataflow plus the device constants of core.types /
core.energy.

Latency model per GEMM (on one DPU, then divided by the DPU count):
    t = t_stream + t_weight_actuation + t_psum + t_readout
  * t_stream: cycles x symbol time (1/DR); HEANA-OS streams folds of the
    same output back-to-back at 10x (TAOM pulse width vs BPD window).
  * t_weight_actuation: per weight switch — thermo-optic 4 us for AMW/MAW
    (the reason their OS/IS dataflows collapse, paper §6.3), electro-optic
    at symbol rate for HEANA (cost already inside t_stream).
  * t_psum: non-BPCA psum round trips through ADC + eDRAM (bandwidth term:
    one access port per DPE FIFO, eDRAM latency per access beyond what the
    symbol pipeline hides) + reduction-network passes.
  * t_readout: one ADC + buffer write per finished output (pipelined;
    charged at the eDRAM latency beyond overlap).

Energy per GEMM: laser (comb lines x wall-plug), DACs (2 per TAOM for
HEANA — weight DAC + input DPC; 1 per MRM + thermo-optic weight drive for
AMW/MAW), ADC conversions, tuning, buffer accesses, reduction passes, plus
accelerator static power x latency.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List

from repro_torch.core import dataflow as df
from repro_torch.core import energy as en
from repro_torch.core.types import (PERIPHERALS, Dataflow, EO_TUNING_LATENCY_NS,
                              OS_COHERENT_PULSES_PER_CYCLE, OpticalParams,
                              TO_TUNING_LATENCY_NS)
from repro_torch.models.cnn import CNN_ZOO, LayerGemm


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """Whole-accelerator geometry the perf model / scheduler consume.

    Like types.PhotonicConfig this is a low-level carrier: derive it from
    a ``core.hw.OperatingPoint`` (``op.accelerator_config()``) so N and
    the DPU count stay functions of (backend, bits, DR) instead of
    hand-set knobs that can drift from the kernel config.
    """
    backend: str                 # heana | amw | maw | amw_bpca | maw_bpca
    dataflow: Dataflow
    data_rate_gsps: float
    n: int                       # DPE size (wavelengths per DPE)
    m: int                       # DPEs per DPU (= n, paper's assumption)
    n_dpus: int

    @classmethod
    def equal_area(cls, backend: str, dataflow: Dataflow,
                   data_rate_gsps: float) -> "AcceleratorConfig":
        """Paper Table 2: area-matched DPU counts at 4-bit precision.

        Delegates to core.hw.OperatingPoint.equal_area — the single
        source of truth for operating-point-derived hardware (prefer
        passing the OperatingPoint itself to the scheduler; it then rides
        along in the plan and pins the kernel config too).
        """
        from repro_torch.core import hw
        return hw.OperatingPoint.equal_area(
            backend, dataflow, data_rate_gsps).accelerator_config()

    @property
    def has_bpca(self) -> bool:
        return self.backend == "heana" or self.backend.endswith("_bpca")

    @property
    def is_heana(self) -> bool:
        return self.backend == "heana"


@dataclasses.dataclass
class GemmCost:
    latency_s: float
    energy: en.EnergyBreakdown


def gemm_cost(g: df.GemmShape, acc: AcceleratorConfig,
              optics: OpticalParams | None = None) -> GemmCost:
    """Latency + energy of one GEMM executed across the whole accelerator."""
    optics = optics or OpticalParams()
    symbol_s = 1e-9 / acc.data_rate_gsps
    # OS coherent-pulse accumulation: TAOM pulses are 100 ps while the BPD
    # integration window is 1/DR — so OS packs min(10, 10/DR) folds of the
    # *same* output into one window (10x at 1 GS/s, 1x at 10 GS/s).
    os_speedup = max(1, round(OS_COHERENT_PULSES_PER_CYCLE /
                              acc.data_rate_gsps)) if acc.is_heana else 1
    sch = df.schedule(g, acc.dataflow, acc.n, acc.m, acc.has_bpca, os_speedup)

    # ---- latency on one DPU ----
    t_stream = sch.cycles * symbol_s
    if acc.is_heana:
        # both operands actuate electro-optically at symbol rate: free.
        t_weights = 0.0
    else:
        # thermo-optic weight actuation; all rings of a DPU tune in parallel
        t_weights = sch.weight_switches * TO_TUNING_LATENCY_NS * 1e-9
    edram_ns = PERIPHERALS["edram"].latency_ns
    red_ns = PERIPHERALS["reduction_network"].latency_ns
    # psum round trips: write+read, partially hidden behind streaming
    hidden_ns = 1e9 * symbol_s
    t_psum = sch.psum_events * max(0.0, 2 * edram_ns - hidden_ns) * 1e-9
    if not acc.has_bpca:
        t_psum += g.outputs * (math.ceil(g.k / acc.n) - 1) * red_ns * 1e-9 \
            / max(acc.m, 1)
    t_readout = g.outputs * max(0.0, edram_ns - hidden_ns) * 1e-9 \
        / max(acc.m, 1)
    t_dpu = t_stream + t_weights + t_psum + t_readout

    # GEMMs parallelize across DPUs (output tiling — embarrassingly
    # parallel).  This division applies to *every* term, including
    # t_weights: the schedule counts above are single-DPU aggregates for
    # the whole GEMM, and distributing output tiles over n_dpus also
    # distributes the weight switches — each DPU performs ~1/n_dpus of
    # them, and different DPUs actuate their rings concurrently.  (A
    # stationary-operand hold that spans tiles on several DPUs is
    # duplicated, not serialized, so thermo-optic actuation never becomes
    # a sequential bottleneck across DPUs.)
    latency = t_dpu / acc.n_dpus

    # ---- energy across the accelerator ----
    e = en.EnergyBreakdown()
    e.laser = en.laser_power_w(acc.n, optics.p_laser_dbm) * t_stream
    # Operand streams: DAC conversions (stationary operand sample-and-held)
    # and unified-buffer fetches (per-DPE FIFO replay of held operands).
    streams = df.stream_counts(g, acc.dataflow, acc.n, acc.m)
    e.dac = (streams.dac_weight + streams.dac_input) * \
        en.dac_energy_per_symbol(acc.backend, acc.data_rate_gsps)
    e.adc = sch.adc_conversions * en.E_ADC_CONV
    if acc.is_heana:
        e.tuning = 0.0   # EO drive energy folded into the (larger) DAC figure
    else:
        e.tuning = sch.weight_switches * acc.n * acc.m * en.E_TO_TUNE_PER_RING
    buf_accesses = (streams.buf_weight + streams.buf_input + g.outputs +
                    2 * sch.psum_events)
    e.buffer = buf_accesses * en.E_EDRAM_ACCESS
    if not acc.has_bpca:
        e.reduction = g.outputs * en.E_REDUCTION_PASS
    # note: static energy is added once at the CNN level (depends on total
    # wall-clock, not per-GEMM accounting)
    return GemmCost(latency, e)


# ---------------------------------------------------------------------------
# Plan-friendly cost API (consumed by repro_torch.exec.scheduler)
# ---------------------------------------------------------------------------
def dataflow_costs(g: df.GemmShape, acc: AcceleratorConfig,
                   flows: Iterable[Dataflow] = tuple(Dataflow),
                   ) -> Dict[Dataflow, GemmCost]:
    """Cost of one GEMM under each candidate dataflow on the same hardware.

    The accelerator's own ``acc.dataflow`` is ignored — each candidate is
    evaluated with the dataflow swapped in, everything else held fixed.
    (Always at default OpticalParams: the plan cache keys on the
    accelerator config alone, so a non-default optics knob here would
    alias cache entries.)
    """
    return {flow: gemm_cost(g, dataclasses.replace(acc, dataflow=flow))
            for flow in flows}


def best_dataflow(g: df.GemmShape, acc: AcceleratorConfig,
                  flows: Iterable[Dataflow] = tuple(Dataflow),
                  objective: str = "latency",
                  ) -> tuple[Dataflow, GemmCost, Dict[Dataflow, GemmCost]]:
    """Argmin dataflow for one GEMM under ``objective``.

    objective: 'latency' | 'energy' | 'edp'.  Ties break deterministically
    by (secondary metric, enum order) so plans are reproducible.
    Returns (winner, winner's cost, all candidate costs).
    """
    costs = dataflow_costs(g, acc, flows)

    def score(item):
        flow, cost = item
        lat, e = cost.latency_s, cost.energy.total
        if objective == "latency":
            key = (lat, e)
        elif objective == "energy":
            key = (e, lat)
        elif objective == "edp":
            key = (lat * e, lat)
        else:
            raise ValueError(f"unknown objective: {objective!r}")
        return (*key, list(Dataflow).index(flow))

    flow, cost = min(costs.items(), key=score)
    return flow, cost, costs


_DYNAMIC_ENERGY_FIELDS = ("laser", "dac", "adc", "tuning", "buffer",
                          "reduction")


def layer_costs(layers, acc: AcceleratorConfig, batch: int = 1,
                dataflows: Iterable[Dataflow] | None = None,
                optics: OpticalParams | None = None) -> List[GemmCost]:
    """Per-layer GemmCosts with batch folded into rows and the layer's
    ``count`` applied — THE accounting path shared by the analytic model
    (``cnn_inference``) and the executed-trace side (core.hw.
    trace_energy): one implementation, so modeled and executed numbers
    cannot drift.

    ``layers`` is anything with ``.c/.k/.d/.count`` (LayerGemm rows, or
    a plan's LayerPlan entries with the batch already folded — pass
    ``batch=1`` then).  The returned costs carry no static-power share
    (that is a whole-network wall-clock term the callers add).
    """
    layers = list(layers)
    if dataflows is None:
        per_layer_acc = [acc] * len(layers)
    else:
        per_layer_acc = [dataclasses.replace(acc, dataflow=flow)
                         for flow in dataflows]
        if len(per_layer_acc) != len(layers):
            raise ValueError("dataflows must match layers one-to-one")
    out: List[GemmCost] = []
    for layer, layer_acc in zip(layers, per_layer_acc):
        g = df.GemmShape(layer.c * batch, layer.k, layer.d)
        cost = gemm_cost(g, layer_acc, optics)
        # `count` independent GEMM instances (depthwise groups): total DPU
        # work scales by count, still spread over the same n_dpus.
        e = en.EnergyBreakdown(**{
            f: getattr(cost.energy, f) * layer.count
            for f in _DYNAMIC_ENERGY_FIELDS})
        out.append(GemmCost(cost.latency_s * layer.count, e))
    return out


@dataclasses.dataclass
class InferenceResult:
    fps: float
    fps_per_watt: float
    latency_s: float
    energy_j: float
    breakdown: en.EnergyBreakdown


def cnn_inference(layers: Iterable[LayerGemm], acc: AcceleratorConfig,
                  batch: int = 1,
                  dataflows: Iterable[Dataflow] | None = None,
                  optics: OpticalParams | None = None,
                  ) -> InferenceResult:
    """FPS and FPS/W for a CNN (list of GEMM layers) on an accelerator.

    Batch size multiplies the Toeplitz row count C (paper evaluates
    batch = 1 and 256): weight-stationary schedules amortize their weight
    loads over the whole batch.

    ``dataflows`` optionally overrides ``acc.dataflow`` per layer (same
    length as ``layers``) — the mixed-dataflow execution a HEANA plan from
    repro_torch.exec.scheduler describes.

    ``optics`` (default OpticalParams) scales the laser-energy term; a
    plan scheduled from an OperatingPoint with non-default optics passes
    them here so modeled totals match the point's physics.
    """
    costs = layer_costs(layers, acc, batch, dataflows, optics)
    total_t = 0.0
    total_e = en.EnergyBreakdown()
    for cost in costs:
        total_t += cost.latency_s
        for f in _DYNAMIC_ENERGY_FIELDS:
            setattr(total_e, f, getattr(total_e, f) + getattr(cost.energy, f))
    total_e.static = en.static_power_w(acc.n_dpus) * total_t
    fps = batch / total_t
    watts = total_e.total / total_t
    return InferenceResult(fps, fps / watts, total_t, total_e.total, total_e)


def evaluate_suite(backends: Iterable[str], dataflows: Iterable[Dataflow],
                   data_rates: Iterable[float], batch: int = 1,
                   cnns: Iterable[str] = tuple(CNN_ZOO),
                   ) -> Dict[tuple, InferenceResult]:
    """The full Figs. 11-14 grid."""
    out = {}
    for cnn_name in cnns:
        layers = CNN_ZOO[cnn_name]()
        for be in backends:
            for flow in dataflows:
                for dr in data_rates:
                    acc = AcceleratorConfig.equal_area(be, flow, dr)
                    out[(cnn_name, be, flow.value, dr)] = cnn_inference(
                        layers, acc, batch)
    return out


def gmean(vals: List[float]) -> float:
    if not vals:
        raise ValueError(
            "gmean of an empty sequence is undefined — the benchmark "
            "suite being aggregated produced no results (check upstream "
            "filters/failures)")
    return math.exp(sum(math.log(v) for v in vals) / len(vals))
