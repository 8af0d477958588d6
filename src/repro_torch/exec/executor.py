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
layer from a ``torch.Generator`` seeded with ``fold_seed(seed, layer)``
(``draw_noise``), before the forward runs, so every layer draws
independent noise and a run is reproducible from one root seed (the
reference folds a PRNG key per layer instead; the streams differ, the
distribution does not).

The executor consumes a CnnPlan from exec.scheduler: each layer's GEMM uses
the plan's tile (block_m, block_d).  The plan's *dataflow* choice changes
scheduling (latency/energy in the report), never numerics — with noise
disabled the executed network equals the plain-version network
(``reference_forward``) bit for bit, whatever the plan says.

Hot path — the reference compiles its forward with ``jax.jit``; the port
captures it in a CUDA graph:

  * ``forward_fn`` is the pure forward of (params, x, noise) with the
    lowering, plan, cfg and impl bound by keyword; it makes no host sync,
    so it captures as it is;
  * ``compiled_forward`` memoizes a ``CompiledForward`` wrapper under the
    reference's key (lowering fingerprint, plan cache keys, cfg, impl,
    collect).  On the card its first call for an input shape and
    parameter set captures the forward into a CUDA graph
    (``trace_count`` counts captures), and later calls replay it; the
    graph replays the same kernels the eager body launches, and gives the
    same bits.  On the CPU it runs the eager body and captures nothing;
  * ``compiled_logits`` is the serving engine's entry: the same walk and
    GEMMs, captured the same way, returning the logits alone, with no
    fingerprint reductions in its graph;
  * per-layer numerics fingerprints (mean |activation|) stay on the device
    as one stacked tensor; ``ExecutionResult.traces`` copies them to the
    host only when a caller asks;
  * ``execute_cnn`` keeps the ExecutionResult API (``compiled=False``
    runs the eager body op by op, the baseline the reference keeps for
    its throughput benchmark).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import cuda_graph
from repro_torch.core import dataflow as df
from repro_torch.core import hw
from repro_torch.core.photonic_gemm import (fold_seed, generator_for,
                                            sample_noise)
from repro_torch.core.types import Backend, PhotonicConfig, resolve_device
from repro_torch.exec import plan_cache as pc
from repro_torch.exec.scheduler import CnnPlan, LayerPlan
from repro_torch.kernels import ops
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import lowering as lw
from repro_torch.runtime import trace

#: A runnable network description: op-graph IR or legacy flat tuple.
Lowering = Union[lw.OpGraph, Sequence[cnn_mod.LoweredLayer]]

_LOWERING_FP_VERSION = 2


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


def _layer_matmul(operand, w: torch.Tensor, cfg: PhotonicConfig,
                  noise: Optional[torch.Tensor], plan: LayerPlan,
                  impl: str) -> torch.Tensor:
    # operand: a 2-D matrix or a conv's lw.ConvOperand (graph_steps).
    return ops.photonic_matmul(operand, w, cfg, noise=noise, impl=impl,
                               block_m=plan.tile.block_m,
                               block_d=plan.tile.block_d)


def _check_seed(cfg: PhotonicConfig, seed: Optional[int]) -> None:
    if cfg.noise_enabled and seed is None:
        raise ValueError(
            "cfg.noise_enabled=True but seed=None — pass a root seed "
            "(per-layer seeds are folded in) or set noise_enabled=False")


def draw_noise(seed: Optional[int], plan: CnnPlan, cfg: PhotonicConfig,
               device) -> Optional[List[torch.Tensor]]:
    """Every GEMM layer's detection noise for one forward, or None with
    noise off: layer i draws ``sample_noise`` at its executed (M, K, D)
    (``LayerGemm.executed``) from a generator on ``device`` seeded with
    ``fold_seed(seed, i)`` — the draw ``photonic_matmul`` would make from
    that generator itself."""
    if not cfg.noise_enabled:
        return None
    _check_seed(cfg, seed)
    draws = []
    for i, p in enumerate(plan.layers):
        m, k, d = lw.LayerGemm(p.name, p.c, p.k, p.d, p.count).executed
        gen = generator_for(fold_seed(seed, i), device)
        draws.append(sample_noise(gen, (m, k), (k, d), cfg))
    return draws


# ---------------------------------------------------------------------------
# Pure forward (the body a CUDA graph captures)
# ---------------------------------------------------------------------------
# Counts captures of the forward into a CUDA graph, the counterpart of the
# reference's jit traces: a warm compiled call replays and leaves it
# untouched.  The lock also guards ``FINGERPRINT_CALLS``: concurrent
# serving threads may capture at once (cold buckets), and ``count += 1``
# is not atomic.
_TRACE_COUNT = 0
_TRACE_LOCK = threading.Lock()

#: Runs of ``forward_fn``'s body, each computing one forward's per-GEMM
#: fingerprints: +1 an eager call; on the card a cold compiled call adds
#: 2 (``cuda_graph.capture`` runs the body once eagerly, then captures
#: it); nothing a replay (a graph runs none of the body's Python).
#: ``compiled_logits``, the serving engine's entry, computes none, so an
#: engine's warm-up and requests leave it as it was.
FINGERPRINT_CALLS = 0


def trace_count() -> int:
    """How many times a forward has been captured into a CUDA graph."""
    with _TRACE_LOCK:
        return _TRACE_COUNT


def _walk(params: Dict[str, torch.Tensor], x: torch.Tensor,
          noise: Optional[Sequence[torch.Tensor]], lowering, plan: CnnPlan,
          cfg: PhotonicConfig, impl: str
          ) -> Tuple[lw.OpGraph, Dict[str, torch.Tensor]]:
    """The graph walk (models.lowering.graph_forward) with the photonic
    GEMMs: every GEMM-bearing node runs through the photonic matmul with
    its LayerPlan's tile and its layer's pre-drawn noise (``draw_noise``;
    None with noise off); glue nodes are plain torch ops.  Returns the
    graph and every node's value."""
    graph = cnn_mod.as_graph(lowering, plan=plan)

    def mm(a, w2d: torch.Tensor, gi: int, node: lw.OpNode) -> torch.Tensor:
        return _layer_matmul(a, w2d, cfg,
                             None if noise is None else noise[gi],
                             plan.layers[gi], impl)

    return graph, lw.graph_forward(params, x, graph, mm)


def forward_fn(params: Dict[str, torch.Tensor], x: torch.Tensor,
               noise: Optional[Sequence[torch.Tensor]] = None, *, lowering,
               plan: CnnPlan, cfg: PhotonicConfig, impl: str,
               collect_activations: bool):
    """Forward: (params, x, noise) -> (logits, fingerprints, acts).

    The photonic graph walk (``_walk``), then a fingerprint per GEMM
    node, its mean |activation|, kept on the device as one stacked
    tensor (``FINGERPRINT_CALLS`` counts the forwards that computed
    them).  No host sync anywhere in the body, so it captures in a CUDA
    graph as it is.
    """
    global FINGERPRINT_CALLS
    graph, vals = _walk(params, x, noise, lowering, plan, cfg, impl)
    gemm_outs = [vals[n.name] for n in graph.gemm_nodes]
    # mean |activation| as sum * (1/size), the reference's formulation.
    fingerprints = torch.stack([v.abs().sum() * (1.0 / v.numel())
                                for v in gemm_outs])
    with _TRACE_LOCK:
        FINGERPRINT_CALLS += 1
    acts = tuple(gemm_outs) if collect_activations else ()
    return vals[graph.output.name], fingerprints, acts


def _logits_fn(params: Dict[str, torch.Tensor], x: torch.Tensor,
               noise: Optional[Sequence[torch.Tensor]] = None, *, lowering,
               plan: CnnPlan, cfg: PhotonicConfig,
               impl: str) -> torch.Tensor:
    """Forward: (params, x, noise) -> logits; ``forward_fn``'s walk and
    GEMMs in the same order, without the fingerprints."""
    graph, vals = _walk(params, x, noise, lowering, plan, cfg, impl)
    return vals[graph.output.name]


def _pin_row(cols: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """cols (M, K) with a last row (amax, 0, ..., 0): its |max| is then
    ``amax`` (>= the shard's own), whatever the shard holds."""
    row = torch.nn.functional.pad(amax.reshape(1, 1).to(cols.dtype),
                                  (0, cols.shape[1] - 1))
    return torch.cat([cols, row])


def _on(device: torch.device):
    """Make ``device`` current for a shard's launches (a kernel launches
    on its tensors' device's stream, which must be the current device's)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class _Shard:
    """One shard of the data-parallel forward (noise off), run a segment
    at a time: segment 0 walks from the input to the first GEMM's
    operand, segment s runs GEMM s - 1 and walks on to GEMM s's operand,
    and the last one ends at the logits (``logits``).  A pinned shard's
    GEMM quantizes with the batch's |max| (``segment``'s ``amax``, see
    ``forward_shards_fn``), and each segment returns the |max| of the
    operand it stops at (None at the end, or unpinned)."""

    def __init__(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
                 graph: lw.OpGraph, plan: CnnPlan, cfg: PhotonicConfig,
                 impl: str, pin: bool) -> None:
        self._steps = lw.graph_steps(params, x, graph)
        self._gemm = None
        self._out = graph.output.name
        self._plan, self._cfg, self._impl, self._pin = plan, cfg, impl, pin
        self.logits: Optional[torch.Tensor] = None

    def segment(self, amax: Optional[torch.Tensor]
                ) -> Optional[torch.Tensor]:
        try:
            if self._gemm is None:
                self._gemm = self._next(next(self._steps))
            else:
                cols, w, gi, _ = self._gemm
                out = _layer_matmul(
                    _pin_row(cols, amax) if self._pin else cols, w,
                    self._cfg, None, self._plan.layers[gi], self._impl)
                self._gemm = self._next(self._steps.send(
                    out[:-1] if self._pin else out))
        except StopIteration as done:
            self.logits = done.value[self._out]
            return None
        return self._gemm[0].abs().amax() if self._pin else None

    def _next(self, gemm: tuple) -> tuple:
        # A pinned operand needs a real row: the im2col matrix (a view of
        # the activation at 1x1, stride 1); unpinned, the operand as it is.
        if not self._pin:
            return gemm
        return (lw.gemm_matrix(gemm[0]),) + tuple(gemm[1:])


def _batch_amax(local: Sequence[torch.Tensor]) -> torch.Tensor:
    """The batch's |max| from the shards' own, on the first shard's
    device (GSPMD's all-reduce of the max)."""
    home = local[0].device
    return torch.stack([a.to(home) for a in local]).amax()


def forward_shards_fn(params: Sequence[Dict[str, torch.Tensor]],
                      xs: Sequence[torch.Tensor], *, lowering,
                      plan: CnnPlan, cfg: PhotonicConfig,
                      impl: str) -> List[torch.Tensor]:
    """The forward over the shards of one batch, noise off: xs[i] (on its
    device, with its replica params[i]) -> each shard's logits.

    The shards walk the graph in lockstep, a segment between two GEMMs at
    a time (``_Shard``).  A photonic GEMM quantizes its activations with
    ONE scale, the max over the whole batch, as the reference's
    data-parallel forward does (GSPMD turns that max into an all-reduce):
    each shard's |max| is reduced over the shards, and the shard's
    operand gets one more row that pins its max to the global one (its
    output row is dropped).  Rows are independent in every GEMM and glue
    op (the global pool sums an image in one order whatever the batch,
    ``lowering._mean_hw``), and the photonic GEMM's integer products are
    exact in any order,
    so each shard's logits are the rows of the one-device forward, bit
    for bit.  (An EXACT-backend GEMM takes no scale and is run as it is.)
    """
    graph = cnn_mod.as_graph(lowering, plan=plan)
    pin = _pins(cfg, xs)
    shards = [_Shard(p, x, graph, plan, cfg, impl, pin)
              for p, x in zip(params, xs)]
    scales = [None] * len(shards)
    for _ in range(len(graph.gemm_nodes) + 1):
        local = []
        for sh, x, scale in zip(shards, xs, scales):
            with _on(x.device):
                local.append(sh.segment(scale))
        if local[0] is not None:
            with trace.span("executor.exchange"):
                amax = _batch_amax(local)
                scales = [amax.to(x.device) for x in xs]
    return [sh.logits for sh in shards]


def _pins(cfg: PhotonicConfig, xs: Sequence[torch.Tensor]) -> bool:
    return cfg.backend != Backend.EXACT and len(xs) > 1


def lowering_fingerprint(lowering) -> str:
    """Content address of a lowered network structure (not its weights),
    as the reference computes it: op graphs hash every node field; legacy
    flat tuples keep their historical layout."""
    if isinstance(lowering, lw.OpGraph):
        layers = [dataclasses.asdict(n) for n in lowering.nodes]
        for d in layers:
            d["inputs"] = list(d["inputs"])
    else:
        layers = [[l.name, l.kind, l.relu, l.pool_after, l.kk]
                  for l in lowering]
    return pc.fingerprint({"v": _LOWERING_FP_VERSION, "layers": layers})


@dataclasses.dataclass
class _Captured:
    """One captured forward: ``replay()`` runs it, reading the static
    input buffers ``static`` and rewriting the static outputs ``outs``;
    ``lock`` serializes copy-in, replay and clone-out, and ``done`` holds
    the last clone-out's event on each device."""
    replay: Callable[[], None]
    static: List[torch.Tensor]
    outs: object
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    done: Dict[torch.device, "torch.cuda.Event"] = dataclasses.field(
        default_factory=dict)


# Graphs kept per compiled wrapper (one per input shape and parameter set).
_GRAPHS_MAX = 8


def _params_key(params: Dict[str, torch.Tensor]) -> tuple:
    return tuple((name, t.data_ptr(), tuple(t.shape), t.dtype)
                 for name, t in sorted(params.items()))


def _clone(outs):
    if isinstance(outs, torch.Tensor):
        return outs.clone()
    return type(outs)(_clone(o) for o in outs)


class _GraphTable:
    """A compiled wrapper's captured forwards by key, LRU-bounded
    (``_GRAPHS_MAX``; evicting one frees its graphs and their pools)."""

    def __init__(self) -> None:
        self._graphs: "OrderedDict[tuple, _Captured]" = OrderedDict()
        self._lock = threading.Lock()

    def run(self, key: tuple, inputs: Sequence[torch.Tensor],
            capture: Callable[[], _Captured]):
        """Copy ``inputs`` into the entry's static buffers, replay, and
        return clones of its static outputs; a new key is captured first
        (``capture()``, counted by ``trace_count``)."""
        with trace.span("executor.graph_wait"):
            entry = self._get(key)
            if entry is not None:
                entry.lock.acquire()
        if entry is None:
            entry = self._add(key, capture)
            entry.lock.acquire()
        try:
            devices = {t.device for t in entry.static}
            with trace.span("executor.copy_in"):
                for d in devices:            # the last caller's clone-out
                    if d in entry.done:
                        torch.cuda.current_stream(d).wait_event(
                            entry.done[d])
                for buf, t in zip(entry.static, inputs):
                    buf.copy_(t)
            with trace.span("executor.replay"):
                entry.replay()
            with trace.span("executor.clone_out"):
                outs = _clone(entry.outs)
                for d in devices:
                    entry.done[d] = torch.cuda.Event()
                    entry.done[d].record(torch.cuda.current_stream(d))
        finally:
            entry.lock.release()
        return outs

    def _get(self, key: tuple) -> Optional[_Captured]:
        with self._lock:
            entry = self._graphs.get(key)
            if entry is not None:
                self._graphs.move_to_end(key)
            return entry

    def _add(self, key: tuple, capture: Callable[[], _Captured]
             ) -> _Captured:
        """Capture ``key``'s entry, unless another caller did meanwhile."""
        global _TRACE_COUNT
        with self._lock:
            entry = self._graphs.get(key)
            if entry is None:
                entry = capture()
                with _TRACE_LOCK:
                    _TRACE_COUNT += 1
                self._graphs[key] = entry
                while len(self._graphs) > _GRAPHS_MAX:
                    self._graphs.popitem(last=False)
            return entry


class CompiledForward:
    """``fn(params, x, seed=None)`` -> what its body returns, for one
    (lowering, plan, cfg, impl) and body: ``forward_fn``'s (logits,
    fingerprints, acts), built by ``compiled_forward``, or the logits
    alone, built by ``compiled_logits``.

    On a CUDA device the first call for an input captures the forward
    into a CUDA graph, keyed by x's shape, dtype and device and by the
    parameters' ``data_ptr``s, shapes and dtypes: a static input buffer,
    static per-layer noise buffers (noise on), the parameters read where
    they lie.  ``core.cuda_graph.capture`` runs the forward eagerly on a
    side stream first, so the kernels' build, library loads and lazy
    module loading never happen inside the capture.  Later calls copy x
    (and the layers' noise, drawn outside the graph by ``draw_noise``)
    into the static buffers, replay, and return clones of the static
    outputs.  Other parameter tensors,
    or another input shape, capture anew (``trace_count``).  A capture or
    replay that fails raises; nothing falls back to the eager body.

    On the CPU it runs the eager body and captures nothing.
    """

    def __init__(self, body: Callable, plan: CnnPlan,
                 cfg: PhotonicConfig) -> None:
        # body(params, x, noise): forward_fn or _logits_fn, all else bound.
        self.plan = plan
        self.cfg = cfg
        self._body = body
        self._graphs = _GraphTable()

    def __call__(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
                 seed: Optional[int] = None):
        noise = draw_noise(seed, self.plan, self.cfg, x.device)
        if x.device.type != "cuda":
            return self._body(params, x, noise)
        key = (tuple(x.shape), x.dtype, x.device, _params_key(params))
        return self._graphs.run(key, [x, *(noise or ())],
                                lambda: self._capture(params, x, noise))

    def _capture(self, params, x, noise) -> _Captured:
        static_x = x.clone()
        static_noise = (None if noise is None
                        else [n.clone() for n in noise])
        graph, outs = cuda_graph.capture(
            lambda: self._body(params, static_x, static_noise), x.device)
        return _Captured(graph.replay, [static_x, *(static_noise or ())],
                         outs)


# Compiled-wrapper memo: (lowering fp, per-layer plan cache keys, cfg,
# impl, collect) -> CompiledForward, the reference's key; the logits-only
# and sharded wrappers share it under keys of their own.  LRU-bounded as the
# reference's is (evicting a wrapper frees its graphs and their pools).
# All access goes through _FORWARD_LOCK: the serving front-end builds
# wrappers from concurrent request threads.
_FORWARD_CACHE: "OrderedDict[tuple, object]" = OrderedDict()
_FORWARD_CACHE_MAX = 256
_FORWARD_LOCK = threading.RLock()


def _memoized(memo_key: tuple, make: Callable[[], object]):
    with _FORWARD_LOCK:
        fn = _FORWARD_CACHE.get(memo_key)
        if fn is None:
            fn = make()
            _FORWARD_CACHE[memo_key] = fn
            while len(_FORWARD_CACHE) > _FORWARD_CACHE_MAX:
                _FORWARD_CACHE.popitem(last=False)
        else:
            _FORWARD_CACHE.move_to_end(memo_key)
        return fn


def compiled_forward(plan: CnnPlan, cfg: PhotonicConfig,
                     lowering: Optional[Lowering] = None,
                     impl: str = "auto",
                     collect_activations: bool = False) -> CompiledForward:
    """The compiled serving entry: returns ``fn(params, x, seed=None)``
    (a ``CompiledForward``: one CUDA graph per input shape and parameter
    set on the card, the eager body on the CPU).

    Two plans that solve the same planning problems (same
    content-addressed cache keys) share one wrapper even if they are
    distinct objects.  Thread-safe.
    """
    lowering = _norm_lowering(lowering)
    memo_key = (lowering_fingerprint(lowering),
                tuple(p.cache_key for p in plan.layers), cfg, impl,
                collect_activations)
    return _memoized(memo_key, lambda: CompiledForward(functools.partial(
        forward_fn, lowering=lowering, plan=plan, cfg=cfg, impl=impl,
        collect_activations=collect_activations), plan, cfg))


def compiled_logits(plan: CnnPlan, cfg: PhotonicConfig,
                    lowering: Optional[Lowering] = None,
                    impl: str = "auto") -> CompiledForward:
    """The serving engine's entry: ``fn(params, x, seed=None) -> logits``,
    a ``CompiledForward`` over ``forward_fn``'s walk without the
    fingerprints, so its CUDA graphs hold no per-GEMM reduction.
    Memoized as ``compiled_forward`` is, under keys of its own: it never
    shares a wrapper with ``compiled_forward``."""
    lowering = _norm_lowering(lowering)
    memo_key = ("logits", lowering_fingerprint(lowering),
                tuple(p.cache_key for p in plan.layers), cfg, impl)
    return _memoized(memo_key, lambda: CompiledForward(functools.partial(
        _logits_fn, lowering=lowering, plan=plan, cfg=cfg, impl=impl),
        plan, cfg))


class ShardedForward:
    """``fn(params_list, xs) -> [logits per shard]`` for one (lowering,
    plan, cfg, impl): ``forward_shards_fn``, the data-parallel serving
    forward (noise off); built by ``sharded_forward``.

    On CUDA devices, the first call for a set of shapes, devices and
    parameters captures each shard's forward into CUDA graphs of its own
    on its own device, one graph per segment between two GEMMs
    (``_Shard``), in one memory pool a shard.  A call replays the
    segments in lockstep; between two segments it reduces the shards'
    |max| and copies it into each shard's static scale buffer, a few
    scalar copies a GEMM, whether the entries share one card or not.
    ``trace_count`` counts one capture per key.  On the CPU it runs the
    eager body."""

    def __init__(self, lowering, plan: CnnPlan, cfg: PhotonicConfig,
                 impl: str) -> None:
        if cfg.noise_enabled:
            raise ValueError("the sharded forward runs noise off")
        self._graph = cnn_mod.as_graph(lowering, plan=plan)
        self._plan, self._cfg, self._impl = plan, cfg, impl
        self._body = functools.partial(forward_shards_fn, lowering=lowering,
                                       plan=plan, cfg=cfg, impl=impl)
        self._graphs = _GraphTable()

    def __call__(self, params: Sequence[Dict[str, torch.Tensor]],
                 xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if any(x.device.type != "cuda" for x in xs):
            return self._body(params, xs)
        key = (tuple((tuple(x.shape), x.dtype, x.device) for x in xs),
               tuple(_params_key(p) for p in params))
        return self._graphs.run(key, xs, lambda: self._capture(params, xs))

    def _capture(self, params, xs) -> _Captured:
        self._body(params, xs)    # first-use costs stay out of the captures
        pin = _pins(self._cfg, xs)
        n_seg = len(self._graph.gemm_nodes) + 1
        static = [x.clone() for x in xs]
        scales = [torch.zeros((), dtype=x.dtype, device=x.device)
                  for x in xs]
        graphs, amaxes, shards = [], [], []
        for p, x, scale in zip(params, static, scales):
            sh = _Shard(p, x, self._graph, self._plan, self._cfg,
                        self._impl, pin)
            segs = cuda_graph.capture_all(
                [lambda: sh.segment(scale)] * n_seg, x.device)
            graphs.append([g for g, _ in segs])
            amaxes.append([a for _, a in segs])
            shards.append(sh)

        def replay() -> None:
            for s in range(n_seg):
                for g, x in zip(graphs, static):
                    with _on(x.device):
                        g[s].replay()
                if pin and s < n_seg - 1:
                    with trace.span("executor.exchange"):
                        amax = _batch_amax([a[s] for a in amaxes])
                        for scale in scales:
                            scale.copy_(amax)
        return _Captured(replay, static, [sh.logits for sh in shards])


def sharded_forward(plan: CnnPlan, cfg: PhotonicConfig,
                    lowering: Optional[Lowering] = None,
                    impl: str = "auto") -> ShardedForward:
    """The data-parallel serving entry, memoized as ``compiled_forward``
    is (its own key space)."""
    lowering = _norm_lowering(lowering)
    memo_key = ("shards", lowering_fingerprint(lowering),
                tuple(p.cache_key for p in plan.layers), cfg, impl)
    return _memoized(memo_key,
                     lambda: ShardedForward(lowering, plan, cfg, impl))


def compile_cache_stats() -> dict:
    with _FORWARD_LOCK:
        return {"entries": len(_FORWARD_CACHE),
                "max_entries": _FORWARD_CACHE_MAX}


def clear_compile_cache() -> None:
    with _FORWARD_LOCK:
        _FORWARD_CACHE.clear()
        _validate_geometry.cache_clear()


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
    _check_seed(cfg, seed)
    hw.check_kernel_plan_coherence(cfg, plan)
    with _FORWARD_LOCK:
        _validate_geometry(lowering, plan, int(h), int(w))


@functools.lru_cache(maxsize=_FORWARD_CACHE_MAX)
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
                compiled: bool = True,
                device=None) -> ExecutionResult:
    """Run a lowered CNN end-to-end through the photonic kernel.

    params: weight dict keyed by GEMM-node (or LoweredLayer) name.
    x: (N, H, W, C) image batch; the plan must have been built for the
      same batch and spatial dims (plan_for_network(in_hw=...)).
    seed: root seed for detection noise (per-layer seeds are folded in);
      REQUIRED when cfg.noise_enabled.
    impl: 'auto' | 'kernel' | 'ref' (forwarded to ops.photonic_matmul).
    compiled: route through ``compiled_forward`` (default): a CUDA graph
      on the card, captured at the first call for this input shape and
      these parameter tensors.  False runs the same body op by op, the
      baseline.  Pass params that already lie on the device: params
      copied there anew on each call are new tensors, and may be captured
      anew.
    device: where to run — the CUDA card unless the caller names another
      device (``device="cpu"`` runs the plain versions); params and x are
      moved there.
    """
    device = resolve_device(device)
    lowering = _norm_lowering(lowering)
    params, x = _on_device(params, x, device)
    _validate(x, plan, cfg, lowering, seed)
    if compiled:
        fn = compiled_forward(plan, cfg, lowering, impl,
                              collect_activations)
        logits, fingerprints, acts = fn(params, x, seed)
    else:
        logits, fingerprints, acts = forward_fn(
            params, x, draw_noise(seed, plan, cfg, x.device),
            lowering=lowering, plan=plan, cfg=cfg, impl=impl,
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
