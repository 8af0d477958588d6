"""Per-layer dataflow auto-scheduler (the paper's "flexible dataflows").

HEANA's TAOM + BPCA combination lets *each layer* of a CNN run under OS,
IS, or WS instead of the single fixed dataflow of prior MRR accelerators
(paper §4, §6.3).  This module exploits that: given a CNN as a list of
im2col GEMMs (models.cnn.LayerGemm) and an AcceleratorConfig, it searches
per layer over {OS, IS, WS} x kernel tiling with the event-driven cost
model (core.perf_model.best_dataflow) and emits a LayerPlan per layer plus
whole-CNN totals.

Because every layer independently takes the argmin of the same cost model
a fixed dataflow would be charged with, the planned CNN latency is <= the
latency under ANY single fixed dataflow — the auto-schedule can only tie
or beat the best fixed choice (benchmarks/autoflow.py asserts this across
the whole CNN zoo at batch 1 and 256).

Tiling: dataflow choice is an analytic-model decision; the tiling choice
is an *executor* decision — which (block_m, block_d) output tile the
TAOM kernel should use for this layer's GEMM.  The search minimizes
padded-output waste, then grid steps; numerics are tile-invariant, so this
is purely a performance knob.

Plans are cached content-addressed (exec.plan_cache): repeated shapes and
configs — within one CNN, across CNNs, or across processes via
dump()/load() — skip the search entirely.

Hashability: TileChoice, LayerPlan and CnnPlan are hashable by value (the
executor memoizes geometry checks on them).  LayerPlan freezes its
``candidates`` mapping at construction; CnnPlan hashes on what determines
it (layers, accelerator, batch, objective) and excludes the derived
perf-model ``result``.

This module is a copy of ``repro.exec.scheduler``: plans, cache keys
included, must equal the reference's field for field, so the tile search
keeps the reference kernel's lane/sublane rounding
(``kernels.taom_gemm.LANE``/``SUBLANE``).  The port's kernel maps the
chosen tile onto its own (see ``kernels.taom_gemm.kernel_tile``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.core import dataflow as df
from repro_torch.core import hw
from repro_torch.core import perf_model as pm
from repro_torch.core.types import Dataflow
from repro_torch.exec import plan_cache as pc
# The reference kernel's tile rounding, kept beside the port's kernel so
# choose_tile returns exactly the reference's tiles (and cache keys).
from repro_torch.kernels.taom_gemm import LANE as _LANE
from repro_torch.kernels.taom_gemm import SUBLANE as _SUBLANE
from repro_torch.kernels.taom_gemm import _round_up
from repro_torch.models.cnn import LayerGemm

# The reference's candidate tiles (its kernel walks M/block_m grid steps
# in order, so it favours large block_m).  Kept unchanged: they enter the
# plan cache key, and the port's plans must equal the reference's.
_BLOCK_M_CANDIDATES = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
_BLOCK_D_CANDIDATES = (128, 256)
# v3: depthwise (count>1, d=1) layers choose their tile for the GEMM the
# executor actually runs — the fused block-diagonal (M, kk*kk*C) @ (.., C)
# — instead of the analytic per-group (M, kk*kk) @ (.., 1) shape.
# v4: plans embed the hardware operating point (repro_torch.core.hw.
# OperatingPoint): scheduling may accept an OperatingPoint directly, the
# CnnPlan carries it for the executor's kernel-cfg coherence check, and
# persisted entries are stamped with the format version so pre-v4 dumps
# cleanly invalidate on load (plan_cache.PLAN_FORMAT_VERSION).
_PLAN_VERSION = pc.PLAN_FORMAT_VERSION

#: What the scheduling entry points accept as "the hardware": a bare
#: AcceleratorConfig (legacy) or a full OperatingPoint (preferred — the
#: plan then pins the kernel config too).
HardwareSpec = Union[pm.AcceleratorConfig, hw.OperatingPoint]


def _resolve_hw(spec: HardwareSpec
                ) -> Tuple[pm.AcceleratorConfig, Optional[hw.OperatingPoint]]:
    if isinstance(spec, hw.OperatingPoint):
        return spec.accelerator_config(), spec
    return spec, None


class FrozenCandidates(dict):
    """Immutable, hashable dataflow -> modeled-latency mapping.

    A dict subclass so it stays JSON-serializable and keeps the plain
    ``plan.candidates["is"]`` read API, but with mutation blocked and a
    content hash — which is what lets LayerPlan (and through it CnnPlan)
    be hashed by value.
    """

    def __hash__(self) -> int:                       # type: ignore[override]
        return hash(tuple(sorted(self.items())))

    def _immutable(self, *args, **kw):
        raise TypeError("FrozenCandidates is immutable")

    __setitem__ = __delitem__ = _immutable
    clear = pop = popitem = setdefault = update = _immutable

    def __reduce__(self):
        # deepcopy/pickle rebuild through __init__ (C-level dict fill),
        # not item assignment, which is blocked.
        return (FrozenCandidates, (dict(self),))


@dataclasses.dataclass(frozen=True)
class TileChoice:
    """Kernel output-tile selection for one GEMM (executor knob)."""
    block_m: int
    block_d: int
    grid_m: int
    grid_d: int
    n_chunks: int          # temporal folds = ceil(K / DPE size)
    pad_waste: float       # padded-output overhead fraction (>= 0)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's scheduled execution: dataflow + tiling + modeled cost."""
    name: str
    c: int                 # GEMM rows (batch already folded in)
    k: int
    d: int
    count: int             # parallel instances (depthwise groups)
    dataflow: Dataflow
    latency_s: float       # modeled, count included
    energy_j: float        # modeled (dynamic, no static share), count incl.
    candidates: Dict[str, float]   # dataflow value -> modeled latency (one
                                   # instance) for report/debugging
    tile: TileChoice
    cache_key: str
    # Run bookkeeping, not plan content: a plan served from the cache must
    # compare (and hash) equal to the freshly searched one.
    cache_hit: bool = dataclasses.field(compare=False)

    def __post_init__(self):
        # Freeze the candidates mapping so the (frozen) dataclass hash —
        # required by the executor's geometry memo — is well defined.
        object.__setattr__(self, "candidates",
                           FrozenCandidates(self.candidates))

    @property
    def gemm(self) -> df.GemmShape:
        return df.GemmShape(self.c, self.k, self.d)


@dataclasses.dataclass(frozen=True, eq=False)
class CnnPlan:
    """A whole CNN's auto-scheduled execution plan.

    Hash/equality cover what *determines* the plan (layers, accelerator,
    batch, objective) — ``result`` is derived from those through the perf
    model and ``cache_hits``/``cache_misses`` are run bookkeeping, so two
    plans of the same problem compare equal (and hit the same memo entry)
    whether they came from the search or the plan cache.
    """
    layers: Tuple[LayerPlan, ...]
    acc: pm.AcceleratorConfig
    batch: int
    objective: str
    result: pm.InferenceResult     # perf-model totals under the plan
    cache_hits: int
    cache_misses: int
    # v4: the operating point the hardware was derived from, when the
    # plan was scheduled from one — lets the executor pin the kernel
    # config (bits/optics included) against the plan, and energy reports
    # carry full provenance.  None for legacy bare-AcceleratorConfig
    # plans (geometry-only coherence).
    op: Optional[hw.OperatingPoint] = None

    def _identity(self) -> tuple:
        return (self.layers, self.acc, self.batch, self.objective, self.op)

    def __eq__(self, other) -> bool:
        if not isinstance(other, CnnPlan):
            return NotImplemented
        return self._identity() == other._identity()

    def __hash__(self) -> int:
        return hash(self._identity())

    @property
    def dataflows(self) -> Tuple[Dataflow, ...]:
        return tuple(p.dataflow for p in self.layers)

    @property
    def latency_s(self) -> float:
        return self.result.latency_s

    @property
    def fps(self) -> float:
        return self.result.fps

    @property
    def fps_per_watt(self) -> float:
        return self.result.fps_per_watt

    def mix(self) -> Dict[str, int]:
        """How many layers landed on each dataflow."""
        out = {f.value: 0 for f in Dataflow}
        for p in self.layers:
            out[p.dataflow.value] += 1
        return out


def choose_tile(m: int, d: int, k: int, dpe_size: int) -> TileChoice:
    """Pick the kernel (block_m, block_d) for an (M, D) output.

    Minimize padded-output elements first (don't burn kernel cycles on
    padding), then grid steps (fewer, larger tiles win ties).  Mirrors the
    reference kernel's clamping, so plans equal the reference's; the
    port's kernel maps the tile onto its own (taom_gemm.kernel_tile).
    """
    best = None
    for bm in _BLOCK_M_CANDIDATES:
        bm_eff = min(bm, _round_up(m, _SUBLANE))
        for bd in _BLOCK_D_CANDIDATES:
            bd_eff = min(bd, _round_up(d, _LANE))
            mp, dp = _round_up(m, bm_eff), _round_up(d, bd_eff)
            grid_m, grid_d = mp // bm_eff, dp // bd_eff
            score = (mp * dp, grid_m * grid_d, bm_eff, bd_eff)
            if best is None or score < best[0]:
                waste = mp * dp / float(m * d) - 1.0
                best = (score, TileChoice(bm_eff, bd_eff, grid_m, grid_d,
                                          max(1, -(-k // dpe_size)), waste))
    return best[1]


def _cache_payload(g: df.GemmShape, count: int, acc: pm.AcceleratorConfig,
                   objective: str, flows: Sequence[Dataflow]) -> dict:
    return {
        "v": _PLAN_VERSION,
        "gemm": [g.c, g.k, g.d],
        "count": count,
        "acc": [acc.backend, acc.data_rate_gsps, acc.n, acc.m, acc.n_dpus],
        "objective": objective,
        "flows": sorted(f.value for f in flows),
        "tiles": [_BLOCK_M_CANDIDATES, _BLOCK_D_CANDIDATES],
    }


def _plan_to_dict(p: LayerPlan) -> dict:
    d = dataclasses.asdict(p)
    d["dataflow"] = p.dataflow.value
    d.pop("name")          # content-addressed: names don't enter the cache
    d.pop("cache_hit")
    d["plan_version"] = _PLAN_VERSION   # load-time invalidation stamp
    return d


def _plan_from_dict(d: dict, name: str, cache_hit: bool) -> LayerPlan:
    return LayerPlan(name=name, c=d["c"], k=d["k"], d=d["d"],
                     count=d["count"], dataflow=Dataflow(d["dataflow"]),
                     latency_s=d["latency_s"], energy_j=d["energy_j"],
                     candidates=dict(d["candidates"]),
                     tile=TileChoice(**d["tile"]),
                     cache_key=d["cache_key"], cache_hit=cache_hit)


def plan_layer(layer: LayerGemm, acc: HardwareSpec, batch: int = 1,
               objective: str = "latency",
               flows: Sequence[Dataflow] = tuple(Dataflow),
               cache: Optional[pc.PlanCache] = None) -> LayerPlan:
    """Schedule one layer: search dataflows x tiling, cache the result."""
    acc, _ = _resolve_hw(acc)
    cache = cache if cache is not None else pc.GLOBAL_PLAN_CACHE
    g = df.GemmShape(layer.c * batch, layer.k, layer.d)
    key = pc.fingerprint(_cache_payload(g, layer.count, acc, objective,
                                        flows))
    cached = cache.get(key)
    if cached is not None:
        return _plan_from_dict(cached, layer.name, cache_hit=True)

    flow, cost, costs = pm.best_dataflow(g, acc, flows, objective)
    # Dataflow cost is charged on the paper's analytic shape (count
    # grouped instances), but the tile must fit the GEMM the executor
    # actually runs — LayerGemm.executed owns that fusion convention
    # (depthwise groups fuse into one block-diagonal GEMM).
    em, ek, ed = LayerGemm(layer.name, g.c, g.k, g.d,
                           layer.count).executed
    tile = choose_tile(em, ed, ek, acc.n)
    plan = LayerPlan(
        name=layer.name, c=g.c, k=g.k, d=g.d, count=layer.count,
        dataflow=flow,
        latency_s=cost.latency_s * layer.count,
        energy_j=cost.energy.total * layer.count,
        candidates={f.value: c.latency_s for f, c in costs.items()},
        tile=tile, cache_key=key, cache_hit=False)
    cache.put(key, _plan_to_dict(plan))
    return plan


def schedule_cnn(layers: Iterable[LayerGemm], acc: HardwareSpec,
                 batch: int = 1, objective: str = "latency",
                 flows: Sequence[Dataflow] = tuple(Dataflow),
                 cache: Optional[pc.PlanCache] = None) -> CnnPlan:
    """Auto-schedule a whole CNN: per-layer dataflow + tiling plan.

    ``acc`` is either a bare AcceleratorConfig (legacy) or an
    OperatingPoint (preferred): an OperatingPoint is resolved to its
    ``accelerator_config()`` for the search AND embedded in the returned
    plan, so the executor can verify the kernel config against the
    hardware the plan was actually scheduled for (plan v4).

    The returned plan's ``result`` holds the perf-model totals (FPS,
    FPS/W, latency, energy incl. static) under the mixed dataflows —
    computed by the same core.perf_model.cnn_inference everything else in
    the repo uses, so planned numbers are directly comparable to the
    fixed-dataflow figures of Figs. 11-14.
    """
    acc, op = _resolve_hw(acc)
    cache = cache if cache is not None else pc.GLOBAL_PLAN_CACHE
    layers = list(layers)
    plans: List[LayerPlan] = [
        plan_layer(layer, acc, batch, objective, flows, cache)
        for layer in layers]
    # Plan totals at the operating point's optics (default optics for
    # legacy plans) — the per-layer search itself stays at default
    # optics (dataflow_costs: the plan cache keys on the accelerator
    # config alone), so LayerPlan.energy_j is a default-optics figure;
    # ``result`` and hw.trace_energy are the op-coherent totals.
    result = pm.cnn_inference(layers, acc, batch,
                              dataflows=[p.dataflow for p in plans],
                              optics=op.optics if op is not None else None)
    hits = sum(1 for p in plans if p.cache_hit)
    return CnnPlan(layers=tuple(plans), acc=acc, batch=batch,
                   objective=objective, result=result,
                   cache_hits=hits, cache_misses=len(plans) - hits, op=op)


def schedule_buckets(layers: Iterable[LayerGemm], acc: HardwareSpec,
                     batches: Sequence[int], objective: str = "latency",
                     flows: Sequence[Dataflow] = tuple(Dataflow),
                     cache: Optional[pc.PlanCache] = None,
                     ) -> Dict[int, CnnPlan]:
    """Schedule one network at several batch sizes (the serving buckets).

    The batched serving engine (exec.serving) plans every power-of-two
    bucket ahead of time; this keeps all of a network's bucket plans on
    one shared plan cache, so layers whose batched GEMM shape repeats
    across buckets (the fc layer, depthwise groups) hit instead of
    re-searching.  Returns {batch: CnnPlan} in the given bucket order.
    """
    cache = cache if cache is not None else pc.GLOBAL_PLAN_CACHE
    layers = list(layers)
    return {int(b): schedule_cnn(layers, acc, batch=int(b),
                                 objective=objective, flows=flows,
                                 cache=cache)
            for b in batches}
