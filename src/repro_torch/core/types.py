"""Core configuration types and physical constants for the HEANA reproduction.

Everything here mirrors the paper's Tables 1 and 3 (a copy of
``repro.core.types`` without the host-accelerator roofline record), plus
``resolve_device``, the port's rule for where entry points run.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional

import torch

# ---------------------------------------------------------------------------
# Physical constants (SI)
# ---------------------------------------------------------------------------
Q_ELECTRON = 1.602176634e-19  # C
K_BOLTZMANN = 1.380649e-23    # J/K


# ---------------------------------------------------------------------------
# Paper Table 1: scalability-analysis parameters
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class OpticalParams:
    """Parameters of Eqs. 1-3 (paper Table 1).

    ``d_mrr_mm`` and ``p_smf_att_db`` are not given in Table 1; they are
    calibrated once against the paper's Fig. 9 anchor (N=83/36/43 at B=4,
    DR=1 GS/s) and then held fixed — see DESIGN.md §6.4.
    """
    p_laser_dbm: float = 10.0          # laser power intensity
    responsivity: float = 1.2          # R, A/W
    r_load: float = 50.0               # R_L, ohm
    i_dark: float = 35e-9              # I_d, A
    temperature: float = 300.0         # K
    rin_db_hz: float = -140.0          # relative intensity noise
    p_ec_il_db: float = 1.44           # fiber-to-chip coupling IL
    p_si_att_db_mm: float = 0.3        # Si waveguide propagation loss
    p_splitter_il_db: float = 0.01     # splitter IL (per split stage)
    p_mrm_il_db: float = 4.0           # microring modulator IL
    p_mrr_w_il_db: float = 0.01        # weight-bank MRR IL
    p_mrm_obl_db: float = 0.01         # out-of-band loss per non-resonant ring
    # Calibrated (DESIGN.md §6.4):
    d_mrr_mm: float = 0.02             # ring diameter / pitch along the bus WG
    p_smf_att_db: float = 0.14         # single-mode fiber attenuation

    @property
    def rin_lin(self) -> float:
        return 10.0 ** (self.rin_db_hz / 10.0)


# Network penalty per DPU organization (paper Table 1).
NETWORK_PENALTY_DB = {
    "heana": 1.8,
    "amw": 5.8,
    "maw": 4.8,
}


# ---------------------------------------------------------------------------
# Paper Table 3: accelerator peripheral power / latency / area
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Peripheral:
    power_mw: float
    latency_ns: float
    area_mm2: float


# Latencies given in "cycles" in Table 3 use the 1 GS/s symbol clock (1 ns).
PERIPHERALS = {
    "reduction_network": Peripheral(0.050, 3.125, 3.00e-5),
    "activation_unit": Peripheral(0.52, 0.78, 6.00e-5),
    "io_interface": Peripheral(140.18, 0.78, 2.44e-2),
    "pooling_unit": Peripheral(0.4, 3.125, 2.40e-4),
    "edram": Peripheral(41.1, 1.56, 1.66e-1),
    "bus": Peripheral(7.0, 5.0, 9.00e-3),
    "router": Peripheral(42.0, 2.0, 1.50e-2),
    "dac_baseline": Peripheral(12.5, 0.78, 2.50e-3),   # [41] — AMW/MAW DACs
    "dac_heana": Peripheral(26.0, 0.78, 6.00e-3),      # [18] — HEANA's 10GS/s DAC
}

EO_TUNING_POWER_W_PER_FSR = 80e-6     # electro-optic actuation
EO_TUNING_LATENCY_NS = 20.0
TO_TUNING_POWER_W_PER_FSR = 275e-3    # thermo-optic actuation (AMW/MAW weights)
TO_TUNING_LATENCY_NS = 4000.0         # 4 us

# BPD inverse bandwidth (1/symbol rate at 1 GS/s) and the TAOM max pulse
# width; their 10x ratio is what lets HEANA-OS accumulate 10 coherent pulses
# per cycle (paper §3.2.4 "Additional Benefits").
BPD_INV_BANDWIDTH_NS = 1.0
TAOM_MAX_PULSE_WIDTH_NS = 0.1
OS_COHERENT_PULSES_PER_CYCLE = int(BPD_INV_BANDWIDTH_NS / TAOM_MAX_PULSE_WIDTH_NS)

# BPCA capacitor-bank size for seamless IS/WS accumulation (paper §3.2.4).
BPCA_NUM_CAPACITORS = 4608


# ---------------------------------------------------------------------------
# Numerics configuration for the photonic GEMM simulation
# ---------------------------------------------------------------------------
class Backend(str, enum.Enum):
    EXACT = "exact"            # plain f32 matmul (no photonics)
    INT_QUANT = "int_quant"    # plain integer quantization, no analog effects
    HEANA = "heana"            # TAOM + BPCA: analog carry, single ADC per output
    AMW = "amw"                # per-DPE-chunk ADC + digital reduction
    MAW = "maw"                # same accumulation policy as AMW, different N
    HEANA_AMW_BPCA = "amw_bpca"  # AMW array given HEANA's BPCA (Fig. 13/14)
    HEANA_MAW_BPCA = "maw_bpca"


class Dataflow(str, enum.Enum):
    WS = "ws"   # weight stationary
    IS = "is"   # input stationary
    OS = "os"   # output stationary


@dataclasses.dataclass(frozen=True)
class PhotonicConfig:
    """Configuration of the photonic numerics simulation.

    ``dpe_size`` is N — the optical dot-product width (number of wavelengths
    = TAOMs per DPE). It is normally derived from the scalability analysis
    (core.scalability.max_dpe_size) for the chosen backend/bits/data-rate.

    PhotonicConfig is the low-level carrier the kernels consume; the
    hardware identity it shares with the scheduler's AcceleratorConfig
    (backend, bits, N, data rate, dataflow, optics) should be DERIVED,
    not hand-set: build both from one ``core.hw.OperatingPoint``
    (``op.kernel_config()`` / ``op.accelerator_config()``).  The
    executor rejects a kernel config that disagrees with the plan's
    hardware (core.hw.check_kernel_plan_coherence).
    """
    backend: Backend = Backend.HEANA
    bits: int = 8                      # operand quantization bits B
    adc_bits: int = 8                  # output ADC resolution
    dpe_size: int = 83                 # N
    data_rate_gsps: float = 1.0        # DR
    dataflow: Dataflow = Dataflow.OS
    noise_enabled: bool = True
    # Optical power reaching each photodiode, per wavelength.  None => derive
    # from the link budget (Eq. 3) at the configured dpe_size.
    pd_power_dbm: Optional[float] = None
    optics: OpticalParams = dataclasses.field(default_factory=OpticalParams)
    # Lane padding of the reference package's kernel.  The port's kernel
    # masks ragged K instead; the field stays so both packages' configs
    # carry the same fields.
    lane_pad: int = 128

    @property
    def qmax(self) -> int:
        return (1 << self.bits) - 1

    @property
    def adc_levels(self) -> int:
        return 1 << self.adc_bits

    def network_penalty_db(self) -> float:
        key = self.backend.value.replace("_bpca", "")
        return NETWORK_PENALTY_DB.get(key, NETWORK_PENALTY_DB["heana"])


def dbm_to_watt(dbm: float) -> float:
    return 1e-3 * 10.0 ** (dbm / 10.0)


def watt_to_dbm(watt: float) -> float:
    return 10.0 * math.log10(max(watt, 1e-30) / 1e-3)


def resolve_device(device=None) -> torch.device:
    """Where an entry point runs: the CUDA card unless the caller names
    another device.  Never falls back to the CPU quietly — with no card and
    no explicit ``device="cpu"`` this raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available — pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device
