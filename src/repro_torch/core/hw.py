"""Unified hardware operating point — ONE source of truth from the
scalability solver down to the executed kernels.

HEANA's headline results are *equal-area* FPS and FPS/W comparisons in
which the achievable DPE size N, the detection-noise level, and every
per-event energy are all functions of one operating point: (backend,
bit-precision B, data rate DR, DPU organization).  Before this module the
repo's executed path took those knobs independently — ``PhotonicConfig``
(kernel numerics), ``AcceleratorConfig`` (scheduler/perf model) and the
noise/energy constants could silently disagree with the analytic model
they claim to reproduce.

``OperatingPoint`` closes that: given (backend, dataflow, bits, DR) it
derives everything downstream from the existing solvers —

  * DPE size N from ``core.scalability.max_dpe_size`` (Eqs. 1-3, Fig. 9);
  * the per-photodiode optical power from the link budget (Eq. 3);
  * the detection sigma from ``core.noise.relative_noise_sigma``;
  * per-event energies from ``core.energy`` (Table 3);

and fans out a *coherent* pair of downstream configs via
``kernel_config()`` (a ``PhotonicConfig`` for the TAOM kernel) and
``accelerator_config()`` (an ``AcceleratorConfig`` for the scheduler /
perf model).  ``repro_torch.exec.scheduler`` embeds the operating point in its
plans (plan v4) and ``repro_torch.exec.executor`` refuses kernel configs that
disagree with a plan's hardware (``check_kernel_plan_coherence``), so the
executed system and the analytic model cannot drift apart.

Executed-trace energy: ``trace_energy(plan)`` turns a CnnPlan's executed
layer list (batch folded into the GEMM rows, per-layer dataflows, grouped
depthwise counts) into per-layer ``EnergyBreakdown``s and whole-network
FPS / FPS/W — charged by the SAME ``core.perf_model.gemm_cost`` event
accounting the analytic figures use, plus the static-power share over the
executed wall-clock.  Depthwise layers are charged on the paper's grouped
accounting (count x (C, k*k, 1) GEMMs): the executor's fused
block-diagonal GEMM is a host-simulation device, not extra photonic work
(the fused matrix is mostly structural zeros).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core import energy as en
from repro_torch.core import noise as noise_mod
from repro_torch.core import scalability
from repro_torch.core.types import (Backend, Dataflow, NETWORK_PENALTY_DB,
                              OpticalParams, PhotonicConfig)

#: Backends with a photonic operating point (EXACT / INT_QUANT bypass the
#: photonic pipeline entirely — no link budget, no detector, no energy).
PHOTONIC_BACKENDS = ("heana", "amw", "maw", "amw_bpca", "maw_bpca")


def _base_backend(backend: str) -> str:
    return backend.replace("_bpca", "")


@dataclasses.dataclass(frozen=True)
class EventEnergies:
    """Per-event energies (J) and standing powers (W) at one operating
    point — the Table 3 constants specialized to (backend, DR, N, DPUs)."""
    adc_j: float              # one ADC conversion
    dac_j: float              # one operand symbol entering the analog domain
    edram_j: float            # one unified-buffer element access
    reduction_j: float        # one reduction-network pass
    to_tune_j: float          # one thermo-optic ring actuation (AMW/MAW)
    laser_w: float            # comb laser electrical power, one DPU
    static_w: float           # always-on peripherals, whole accelerator


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One hardware operating point: (backend, dataflow, bits, DR) plus the
    solver-derived DPE geometry.

    Construct via :meth:`design` (N solved from the scalability analysis,
    paper Fig. 9) or :meth:`equal_area` (paper Table 2's area-matched
    (N, DPU-count) pairs at B=4).  The raw constructor accepts explicit
    ``dpe_size``/``n_dpus`` overrides for expert use; ``None`` means
    "derive" (the normal case).

    Everything downstream hangs off this object: ``kernel_config()`` and
    ``accelerator_config()`` produce the coherent config pair, and
    ``noise_sigma()`` / ``event_energies()`` expose the derived physics so
    reports can show *why* the numbers are what they are.
    """
    backend: str = "heana"
    dataflow: Dataflow = Dataflow.OS
    bits: int = 4                      # operand precision B (paper: 4)
    data_rate_gsps: float = 1.0        # DR
    dpe_size: Optional[int] = None     # N; None => solve from (B, DR)
    n_dpus: Optional[int] = None       # None => 1 (design) / Table 2
    adc_bits: int = 8
    noise_enabled: bool = True
    optics: OpticalParams = dataclasses.field(default_factory=OpticalParams)

    def __post_init__(self):
        if _base_backend(self.backend) not in NETWORK_PENALTY_DB:
            raise ValueError(
                f"unknown photonic backend {self.backend!r} — expected one "
                f"of {PHOTONIC_BACKENDS} (EXACT/INT_QUANT have no "
                f"operating point; build a PhotonicConfig directly)")
        if self.dpe_size is None:
            n = scalability.max_dpe_size(self.backend, self.bits,
                                         self.data_rate_gsps, self.optics)
            if n < 1:
                raise ValueError(
                    f"{self.bits}-bit operation at "
                    f"{self.data_rate_gsps} GS/s is optically infeasible "
                    f"for {self.backend!r} (link budget cannot deliver "
                    f"the required receiver power even at N=1 — the "
                    f"paper Fig. 9 RIN cliff)")
            object.__setattr__(self, "dpe_size", n)
        elif self.dpe_size < 1:
            raise ValueError(f"dpe_size must be >= 1, got {self.dpe_size}")
        if self.n_dpus is None:
            object.__setattr__(self, "n_dpus", 1)
        elif self.n_dpus < 1:
            raise ValueError(f"n_dpus must be >= 1, got {self.n_dpus}")

    # -- constructors --------------------------------------------------------
    @classmethod
    def design(cls, backend: str, dataflow: Dataflow = Dataflow.OS,
               bits: int = 4, data_rate_gsps: float = 1.0,
               n_dpus: int = 1, **kw) -> "OperatingPoint":
        """The Fig. 9 design point: N solved from the scalability analysis
        for (backend, bits, DR)."""
        return cls(backend=backend, dataflow=dataflow, bits=bits,
                   data_rate_gsps=data_rate_gsps, n_dpus=n_dpus, **kw)

    @classmethod
    def equal_area(cls, backend: str, dataflow: Dataflow = Dataflow.OS,
                   data_rate_gsps: float = 1.0, **kw) -> "OperatingPoint":
        """Paper Table 2: the area-matched system evaluation points at
        B=4 — (N, DPU count) pairs normalized to HEANA(N=83, 50 DPUs).

        N comes from the published table, not the solver (the solver
        reproduces 8 of the 9 anchors exactly; Table 2's MAW@5GS/s entry
        is the documented off-by-one — the table wins here so the
        equal-area figures match the paper's).
        """
        n, count = scalability.table2_dpu_config(backend, data_rate_gsps)
        return cls(backend=backend, dataflow=dataflow, bits=4,
                   data_rate_gsps=data_rate_gsps, dpe_size=n,
                   n_dpus=count, **kw)

    # -- derived physics -----------------------------------------------------
    @property
    def n(self) -> int:
        """DPE size N (wavelengths per DPE; M = N DPEs per DPU)."""
        return self.dpe_size

    def pd_power_dbm(self) -> float:
        """Per-wavelength optical power at the photodiode: the Eq. 3 link
        budget evaluated at this point's N (M = N, paper's assumption)."""
        key = _base_backend(self.backend)
        return scalability.output_power_dbm(
            self.n, self.n, NETWORK_PENALTY_DB[key], self.optics,
            scalability.obl_passes_for(self.backend))

    def noise_sigma(self) -> float:
        """Relative detection-noise sigma of one BPD integration event at
        this operating point (== ``noise.relative_noise_sigma`` at the
        link-budget power — the same sigma the kernels inject)."""
        return noise_mod.relative_noise_sigma(
            self.pd_power_dbm(), self.data_rate_gsps, self.optics)

    def enob(self) -> float:
        """Effective number of bits actually resolvable at this point."""
        return noise_mod.enob(self.pd_power_dbm(), self.data_rate_gsps,
                              self.optics)

    def event_energies(self) -> EventEnergies:
        """Per-event energies / standing powers (core.energy, Table 3)."""
        return EventEnergies(
            adc_j=en.E_ADC_CONV,
            dac_j=en.dac_energy_per_symbol(self.backend,
                                           self.data_rate_gsps),
            edram_j=en.E_EDRAM_ACCESS,
            reduction_j=en.E_REDUCTION_PASS,
            to_tune_j=en.E_TO_TUNE_PER_RING,
            laser_w=en.laser_power_w(self.n, self.optics.p_laser_dbm),
            static_w=en.static_power_w(self.n_dpus),
        )

    # -- coherent downstream configs -----------------------------------------
    def kernel_config(self, **overrides) -> PhotonicConfig:
        """The numerics config the TAOM kernel consumes, derived from
        this point — same backend, bits, N, DR, dataflow and optics, so
        the injected noise sigma IS ``noise_sigma()``.

        ``overrides`` replace fields on the derived config (e.g.
        ``noise_enabled=False`` for deterministic runs, ``adc_bits=...``).
        Overriding the hardware identity (backend / bits / dpe_size /
        data_rate_gsps) defeats the point of the operating point and will
        be rejected by the executor's coherence check against a plan
        carrying this point.
        """
        cfg = PhotonicConfig(
            backend=Backend(self.backend), bits=self.bits,
            adc_bits=self.adc_bits, dpe_size=self.n,
            data_rate_gsps=self.data_rate_gsps, dataflow=self.dataflow,
            noise_enabled=self.noise_enabled, optics=self.optics)
        return dataclasses.replace(cfg, **overrides) if overrides else cfg

    def accelerator_config(self):
        """The scheduler / perf-model AcceleratorConfig for this point
        (``repro_torch.core.perf_model.AcceleratorConfig``; imported lazily —
        perf_model pulls in the model zoo)."""
        from repro_torch.core import perf_model as pm
        return pm.AcceleratorConfig(
            backend=self.backend, dataflow=self.dataflow,
            data_rate_gsps=self.data_rate_gsps, n=self.n, m=self.n,
            n_dpus=self.n_dpus)

    def describe(self) -> dict:
        """JSON-safe summary (reports / experiment provenance)."""
        return {
            "backend": self.backend,
            "dataflow": self.dataflow.value,
            "bits": self.bits,
            "data_rate_gsps": self.data_rate_gsps,
            "dpe_size": self.n,
            "n_dpus": self.n_dpus,
            "pd_power_dbm": self.pd_power_dbm(),
            "noise_sigma_rel": self.noise_sigma(),
            "enob": self.enob(),
            "static_w": self.event_energies().static_w,
        }


# ---------------------------------------------------------------------------
# Kernel-config <-> plan coherence (consumed by repro_torch.exec.executor)
# ---------------------------------------------------------------------------
#: Kernel backends that bypass the photonic pipeline — no geometry to check.
_NON_PHOTONIC = (Backend.EXACT, Backend.INT_QUANT)


def kernel_plan_mismatches(cfg: PhotonicConfig, acc,
                           op: Optional[OperatingPoint] = None
                           ) -> List[str]:
    """Field-by-field disagreement between a kernel config and the
    hardware a plan was scheduled for.  Empty list == coherent.

    ``acc`` is the plan's AcceleratorConfig; ``op`` the plan's embedded
    OperatingPoint when it has one (plan v4).  Without an operating point
    only the geometry the AcceleratorConfig carries (backend organization,
    DPE size N, data rate) is checkable — ``bits`` lives on the operating
    point, so legacy plans cannot pin it.
    """
    if cfg.backend in _NON_PHOTONIC:
        return []
    probs: List[str] = []
    if cfg.backend.value != acc.backend:
        probs.append(f"backend: kernel cfg simulates "
                     f"{cfg.backend.value!r} but the plan was scheduled "
                     f"for {acc.backend!r}")
    if cfg.dpe_size != acc.n:
        probs.append(f"DPE size: kernel cfg folds K in chunks of "
                     f"N={cfg.dpe_size} but the plan's hardware has "
                     f"N={acc.n}")
    if cfg.data_rate_gsps != acc.data_rate_gsps:
        probs.append(f"data rate: kernel cfg at {cfg.data_rate_gsps} GS/s "
                     f"vs the plan's {acc.data_rate_gsps} GS/s")
    if op is not None:
        if cfg.bits != op.bits:
            probs.append(f"bits: kernel cfg quantizes to B={cfg.bits} but "
                         f"the operating point was solved for B={op.bits} "
                         f"(its N={op.n} is only achievable at that "
                         f"precision)")
        if cfg.optics != op.optics:
            probs.append("optics: kernel cfg and operating point carry "
                         "different OpticalParams — their link budgets "
                         "(and noise sigmas) disagree")
        if cfg.pd_power_dbm is not None and \
                cfg.pd_power_dbm != op.pd_power_dbm():
            probs.append(
                f"PD power: kernel cfg hand-sets "
                f"{cfg.pd_power_dbm:.3f} dBm at the photodiode but the "
                f"operating point's link budget delivers "
                f"{op.pd_power_dbm():.3f} dBm — the injected noise "
                f"sigma would disagree with the solved precision "
                f"(leave pd_power_dbm=None to derive it)")
    return probs


def check_kernel_plan_coherence(cfg: PhotonicConfig, plan) -> None:
    """Raise ValueError when a kernel config disagrees with ``plan``'s
    hardware (``execute_cnn`` calls this on every call, a
    ``ServingEngine`` once for each bucket's plan).

    ``plan`` is duck-typed: anything with ``.acc`` and (optionally)
    ``.op`` — i.e. a scheduler CnnPlan.
    """
    probs = kernel_plan_mismatches(cfg, plan.acc,
                                   getattr(plan, "op", None))
    if probs:
        fix = ("derive both configs from one OperatingPoint — "
               "op.kernel_config() for the kernels and "
               "schedule_cnn(..., op) (or plan_for_network(params, op)) "
               "for the plan — instead of setting the knobs by hand")
        raise ValueError(
            "kernel config and plan describe DIFFERENT hardware — the "
            "executed numerics would silently diverge from the modeled "
            "latency/energy:\n  - " + "\n  - ".join(probs) + f"\nFix: {fix}")


# ---------------------------------------------------------------------------
# Executed-trace energy accounting (consumed by repro_torch.exec.executor)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TraceEnergy:
    """Whole-network energy/FPS accounting of one executed plan.

    ``per_layer_j`` follows the plan's layer order (count included, no
    static share); ``breakdown`` holds the component totals including the
    static-power share over the executed wall-clock.  FPS and FPS/W are
    the executed-trace equivalents of ``perf_model.InferenceResult`` — by
    construction they agree with ``cnn_inference`` run at the same
    per-layer dataflows (pinned by tests/test_energy_trace.py).
    """
    batch: int
    latency_s: float
    per_layer_j: Tuple[float, ...]
    breakdown: en.EnergyBreakdown

    @property
    def energy_j(self) -> float:
        return self.breakdown.total

    @property
    def fps(self) -> float:
        return self.batch / self.latency_s

    @property
    def watts(self) -> float:
        return self.breakdown.total / self.latency_s

    @property
    def fps_per_watt(self) -> float:
        return self.fps / self.watts

    @property
    def j_per_image(self) -> float:
        return self.breakdown.total / self.batch


def trace_energy(plan, optics: Optional[OpticalParams] = None
                 ) -> TraceEnergy:
    """Energy/FPS of what a plan's executor run actually does.

    Walks the plan's executed layer list — batch already folded into the
    GEMM rows, the auto-scheduled per-layer dataflow, the paper's grouped
    depthwise accounting — and charges each layer with the SAME
    ``perf_model.gemm_cost`` event accounting the analytic figures use,
    then adds the static-power share over the summed wall-clock.  One
    accounting path for modeled and executed numbers: coherence by
    construction.

    Optics: charged at the plan's operating-point optics (default
    OpticalParams for legacy plans) — the same optics ``schedule_cnn``
    passes to ``cnn_inference`` for the plan's ``result``, so executed
    and modeled totals agree for non-default optics too.  Note the
    cached per-layer ``LayerPlan.energy_j`` is always a default-optics
    figure (the plan cache keys on the accelerator config alone); only
    the laser term differs.
    """
    from repro_torch.core import perf_model as pm
    optics = optics or (plan.op.optics if getattr(plan, "op", None)
                        else None)
    # THE shared accounting path (perf_model.layer_costs — the same one
    # cnn_inference sums): plan.layers carry batch-folded rows, so
    # batch=1 here; the per-layer dataflows are the plan's.
    costs = pm.layer_costs(plan.layers, plan.acc, batch=1,
                           dataflows=[p.dataflow for p in plan.layers],
                           optics=optics)
    total_t = 0.0
    total = en.EnergyBreakdown()
    per_layer: List[float] = []
    for cost in costs:
        total_t += cost.latency_s
        for f in pm._DYNAMIC_ENERGY_FIELDS:
            setattr(total, f, getattr(total, f) + getattr(cost.energy, f))
        per_layer.append(cost.energy.total)
    total.static = en.static_power_w(plan.acc.n_dpus) * total_t
    return TraceEnergy(batch=plan.batch, latency_s=total_t,
                       per_layer_j=tuple(per_layer), breakdown=total)
