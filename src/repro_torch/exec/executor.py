"""End-to-end CNN executor over the TAOM kernel (PyTorch counterpart of
``repro.exec.executor``).

Runs a *runnable* GEMM-lowered CNN (a models.lowering.OpGraph or a legacy
flat models.cnn.LoweredLayer tuple, + params dict) image-batch in, logits
out, with every GEMM executed by kernels.ops.photonic_matmul: quantize ->
TAOM GEMM (the Hopper kernel on the card, the plain version on the CPU)
-> rescale.

Batching follows the paper's Toeplitz accounting: the image batch folds
into the GEMM M axis, which is both the batch-serving shape and what
core.perf_model charges for batched layers.  Detection noise is drawn per
layer from a ``torch.Generator`` seeded with ``fold_seed(seed, layer)``, so
every layer draws independent noise and a run is reproducible from one
root seed (the reference folds a PRNG key per layer instead; the streams
differ, the distribution does not).

The executor consumes a CnnPlan from exec.scheduler: each layer's GEMM uses
the plan's tile (block_m, block_d).  The plan's *dataflow* choice changes
scheduling (latency/energy in the report), never numerics — with noise
disabled the executed network equals the plain-version network
(``reference_forward``) bit for bit, whatever the plan says.

PyTorch runs eagerly, so there is no compiled forward to memoize: every
call walks the graph and launches one kernel per GEMM node.  Per-layer
numerics fingerprints (mean |activation|) stay on the device as one
stacked tensor; ``ExecutionResult.traces`` copies them to the host only
when a caller asks.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.core import dataflow as df
from repro_torch.core import hw
from repro_torch.core.photonic_gemm import fold_seed, generator_for
from repro_torch.core.types import PhotonicConfig, resolve_device
from repro_torch.exec.scheduler import CnnPlan, LayerPlan
from repro_torch.kernels import ops
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import lowering as lw

#: A runnable network description: op-graph IR or legacy flat tuple.
Lowering = Union[lw.OpGraph, Sequence[cnn_mod.LoweredLayer]]

# The geometry memo is bounded like the reference's (each entry pins its
# plan and lowering).
_GEOMETRY_CACHE_MAX = 256
_GEOMETRY_LOCK = threading.Lock()


@dataclasses.dataclass
class LayerTrace:
    """What actually ran for one layer (executed next to modeled)."""
    name: str
    m: int                 # executed GEMM rows (batch folded in)
    k: int
    d: int
    dataflow: str
    block_m: int
    block_d: int
    latency_s: float       # modeled (from the plan)
    energy_j: float        # modeled (from the plan)
    out_mean_abs: float    # executed-numerics fingerprint
    n_chunks: int = 0
    adc_conversions: int = 0
    executed_energy_j: float = 0.0


@dataclasses.dataclass
class ExecutionResult:
    """Logits + plan + lazily materialized per-layer traces.

    ``fingerprints`` is the (n_layers,) device tensor of mean-|activation|
    per GEMM layer.  ``traces`` copies it to the host on FIRST ACCESS — a
    serving loop that never reads traces never waits on them.
    """
    logits: torch.Tensor
    plan: CnnPlan
    fingerprints: torch.Tensor
    activations: Optional[List[torch.Tensor]] = None
    _traces: Optional[List[LayerTrace]] = dataclasses.field(
        default=None, repr=False)
    _energy: Optional[hw.TraceEnergy] = dataclasses.field(
        default=None, repr=False)

    @property
    def traces(self) -> List[LayerTrace]:
        if self._traces is None:
            fp = [float(v) for v in self.fingerprints.tolist()]
            energy = self.energy()
            acc = self.plan.acc
            self._traces = []
            for i, p in enumerate(self.plan.layers):
                m, k, d = lw.LayerGemm(p.name, p.c, p.k, p.d,
                                       p.count).executed
                sch = df.schedule(df.GemmShape(p.c, p.k, p.d), p.dataflow,
                                  acc.n, acc.m, acc.has_bpca)
                self._traces.append(LayerTrace(
                    name=p.name, m=m, k=k, d=d,
                    dataflow=p.dataflow.value, block_m=p.tile.block_m,
                    block_d=p.tile.block_d, latency_s=p.latency_s,
                    energy_j=p.energy_j, out_mean_abs=fp[i],
                    n_chunks=p.tile.n_chunks,
                    adc_conversions=sch.adc_conversions * p.count,
                    executed_energy_j=energy.per_layer_j[i]))
        return self._traces

    @property
    def modeled_latency_s(self) -> float:
        return self.plan.latency_s

    @property
    def modeled_fps(self) -> float:
        return self.plan.fps

    def energy(self) -> hw.TraceEnergy:
        """Executed-trace energy/FPS accounting of this run (memoized),
        computed on the host from the plan via core.hw.trace_energy."""
        if self._energy is None:
            self._energy = hw.trace_energy(self.plan)
        return self._energy

    @property
    def executed_energy_j(self) -> float:
        """Total executed-trace energy for this batch (static incl.)."""
        return self.energy().energy_j

    @property
    def executed_fps_per_watt(self) -> float:
        return self.energy().fps_per_watt


def _norm_lowering(lowering):
    """Default + normalize: None -> the small CNN; OpGraph passes
    through; anything else is frozen into a legacy flat tuple (both forms
    are hashable, as the geometry memo needs)."""
    if lowering is None:
        return cnn_mod.small_cnn_lowering()
    if isinstance(lowering, lw.OpGraph):
        return lowering
    return tuple(lowering)


def _layer_matmul(cols: torch.Tensor, w: torch.Tensor, cfg: PhotonicConfig,
                  generator: Optional[torch.Generator], plan: LayerPlan,
                  impl: str) -> torch.Tensor:
    return ops.photonic_matmul(cols, w, cfg, generator=generator, impl=impl,
                               block_m=plan.tile.block_m,
                               block_d=plan.tile.block_d)


def _forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
             seed: Optional[int] = None, *, lowering, plan: CnnPlan,
             cfg: PhotonicConfig, impl: str, collect_activations: bool):
    """Forward: (params, x, seed) -> (logits, fingerprints, acts).

    Walks the lowering's op graph (models.lowering.graph_forward): every
    GEMM-bearing node runs through the photonic matmul with its
    LayerPlan's tile and its own noise generator; glue nodes are plain
    torch ops.  Fingerprints are per GEMM node, taken right after its
    activation, and stay on the device.
    """
    graph = cnn_mod.as_graph(lowering, plan=plan)

    def mm(a2d: torch.Tensor, w2d: torch.Tensor, gi: int,
           node: lw.OpNode) -> torch.Tensor:
        gen = (generator_for(fold_seed(seed, gi), a2d.device)
               if seed is not None and cfg.noise_enabled else None)
        return _layer_matmul(a2d, w2d, cfg, gen, plan.layers[gi], impl)

    vals = lw.graph_forward(params, x, graph, mm)
    gemm_outs = [vals[n.name] for n in graph.gemm_nodes]
    # mean |activation| as sum * (1/size), the reference's formulation.
    fingerprints = torch.stack([v.abs().sum() * (1.0 / v.numel())
                                for v in gemm_outs])
    acts = tuple(gemm_outs) if collect_activations else ()
    return vals[graph.output.name], fingerprints, acts


# ---------------------------------------------------------------------------
# Validation (before running — clear errors instead of reshape noise)
# ---------------------------------------------------------------------------
def _gemm_count(lowering) -> int:
    if isinstance(lowering, lw.OpGraph):
        return len(lowering.gemm_nodes)
    return len(lowering)


def _validate(x: torch.Tensor, plan: CnnPlan, cfg: PhotonicConfig,
              lowering, seed: Optional[int]) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C) images, got shape "
                         f"{tuple(x.shape)}")
    if len(plan.layers) != _gemm_count(lowering):
        raise ValueError(
            f"plan has {len(plan.layers)} layers, lowering has "
            f"{_gemm_count(lowering)} GEMM layers — plan the "
            f"lowered_gemms of this network")
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    if n != plan.batch:
        raise ValueError(
            f"plan was scheduled for batch {plan.batch} but x has batch "
            f"{n} — modeled and executed numbers would disagree; for "
            f"mixed-size traffic use exec.serving.ServingEngine, which "
            f"pads each request up to a power-of-two batch bucket with "
            f"its own plan and slices the results back")
    if cfg.noise_enabled and seed is None:
        raise ValueError(
            "cfg.noise_enabled=True but seed=None — pass a root seed "
            "(per-layer seeds are folded in) or set noise_enabled=False")
    hw.check_kernel_plan_coherence(cfg, plan)
    with _GEOMETRY_LOCK:
        _validate_geometry(lowering, plan, int(h), int(w))


@functools.lru_cache(maxsize=_GEOMETRY_CACHE_MAX)
def _validate_geometry(lowering, plan: CnnPlan, h: int, w: int) -> None:
    """Structural checks, memoized on (lowering, plan, H, W): infers every
    node's shape for these spatial dims, then pins each GEMM node against
    its LayerPlan (the plan must have been built for this geometry)."""
    graph = cnn_mod.as_graph(lowering, plan=plan)
    shapes = lw.infer_shapes(graph, (h, w))
    for node, lplan in zip(graph.gemm_nodes, plan.layers):
        oh, ow, oc = shapes[node.name]
        rows = plan.batch if node.op == "fc" else plan.batch * oh * ow
        if lplan.c != rows:
            where = (f"the batch is {plan.batch}" if node.op == "fc" else
                     f"the input reaches this layer as {plan.batch} x "
                     f"{oh}x{ow} = {rows} rows")
            raise ValueError(
                f"{node.name}: plan expects {lplan.c} GEMM rows but "
                f"{where} — plan_for_network(in_hw=({h}, {w})) "
                f"for this input size")
        if node.op == "depthwise_conv":
            ic = shapes[node.inputs[0]][2]
            if lplan.count != ic:
                raise ValueError(
                    f"{node.name}: plan has count={lplan.count} depthwise "
                    f"groups but the input reaches this layer with "
                    f"{ic} channels — replan this network")
        elif lplan.d != oc:
            raise ValueError(
                f"{node.name}: plan has D={lplan.d} output channels but "
                f"the lowering implies {oc} — plan and lowering come "
                f"from different networks")


def _on_device(params: Dict[str, torch.Tensor], x, device: torch.device):
    params = {k: torch.as_tensor(v).to(device) for k, v in params.items()}
    return params, torch.as_tensor(x).to(device=device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def execute_cnn(params: Dict[str, torch.Tensor], x: torch.Tensor,
                plan: CnnPlan, cfg: PhotonicConfig,
                seed: Optional[int] = None,
                impl: str = "auto",
                lowering: Optional[Lowering] = None,
                collect_activations: bool = False,
                device=None) -> ExecutionResult:
    """Run a lowered CNN end-to-end through the photonic kernel.

    params: weight dict keyed by GEMM-node (or LoweredLayer) name.
    x: (N, H, W, C) image batch; the plan must have been built for the
      same batch and spatial dims (plan_for_network(in_hw=...)).
    seed: root seed for detection noise (per-layer seeds are folded in);
      REQUIRED when cfg.noise_enabled.
    impl: 'auto' | 'kernel' | 'ref' (forwarded to ops.photonic_matmul).
    device: where to run — the CUDA card unless the caller names another
      device (``device="cpu"`` runs the plain versions); params and x are
      moved there.
    """
    device = resolve_device(device)
    lowering = _norm_lowering(lowering)
    params, x = _on_device(params, x, device)
    _validate(x, plan, cfg, lowering, seed)
    logits, fingerprints, acts = _forward(
        params, x, seed, lowering=lowering, plan=plan, cfg=cfg, impl=impl,
        collect_activations=collect_activations)
    return ExecutionResult(
        logits=logits, plan=plan, fingerprints=fingerprints,
        activations=list(acts) if collect_activations else None)


def reference_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                      cfg: PhotonicConfig,
                      lowering: Optional[Lowering] = None,
                      device=None) -> torch.Tensor:
    """Plain-version forward: the same quantize->accumulate->ADC math via
    kernels/ref.py, driven through the same lowered structure the executor
    runs (models.cnn.lowered_apply).  With noise disabled,
    ``execute_cnn(..., impl='kernel')`` must equal this exactly."""
    device = resolve_device(device)
    params, x = _on_device(params, x, device)
    mm: Callable = lambda a, w: ops.photonic_matmul(a, w, cfg, impl="ref")
    return cnn_mod.lowered_apply(params, x, _norm_lowering(lowering),
                                 matmul=mm)


def plan_for_network(params: Dict[str, torch.Tensor],
                     acc, batch: int = 1, in_hw=16,
                     lowering: Optional[Lowering] = None,
                     **schedule_kw) -> CnnPlan:
    """Lower a runnable network's GEMM table and schedule it.

    ``acc``: an AcceleratorConfig or (preferred) a core.hw.OperatingPoint.
    ``in_hw``: input spatial size — an int or an (H, W) pair.
    """
    from repro_torch.exec.scheduler import schedule_cnn
    gemms = cnn_mod.lowered_gemms(params, lowering, in_hw)
    return schedule_cnn(gemms, acc, batch=batch, **schedule_kw)
