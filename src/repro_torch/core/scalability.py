"""Scalability analysis — paper Section 5 (Eqs. 1-3, Fig. 9, Table 2).

Given an operand bit-precision B and data rate DR, the achievable DPE size N
is the largest N for which the optical power that survives the link budget
(Eq. 3) still meets the receiver sensitivity P_PD-opt required for B bits at
DR (Eqs. 1-2, inverted in core.noise).

The link budget is evaluated with M = N (paper's assumption) and differs
between the DPU organizations only through the network penalty P_penalty
(Table 1: HEANA 1.8 dB, MAW 4.8 dB, AMW 5.8 dB) — the hitless TAOM
arrangement is what buys HEANA its much smaller penalty and hence its much
larger N.

Calibration note (DESIGN.md §6.4): Table 1 omits d_MRR and P_SMF-att.  With
d_MRR = 0.02 mm, P_SMF-att = 0.14 dB, and a single out-of-band-loss pass for
HEANA (its hitless arrangement routes each wavelength through the filter
array once, vs the MRM-array + weight-bank double pass of AMW/MAW) the
solver reproduces 8 of the paper's 9 Fig.9/Table 2 anchors exactly at B=4
(HEANA 83/42/30, AMW 36/17/12, MAW 43/[22 vs 21]/15); these values are held
fixed everywhere else.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

from repro_torch.core import noise
from repro_torch.core.types import NETWORK_PENALTY_DB, OpticalParams

MAX_N = 4096


def output_power_dbm(n: int, m: int, penalty_db: float,
                     optics: OpticalParams, obl_passes: int = 2) -> float:
    """Optical power reaching one photodiode — paper Eq. 3.

    ``obl_passes`` is the number of times a wavelength suffers the
    out-of-band loss of the other N-1 rings: 2 for AMW/MAW (MRM input array
    then MRR weight bank), 1 for HEANA's hitless arrangement (each
    wavelength crosses the mono-wavelength filter array once).
    """
    if n < 1 or m < 1:
        raise ValueError("N and M must be >= 1")
    p = optics.p_laser_dbm
    p -= optics.p_smf_att_db
    p -= optics.p_ec_il_db
    p -= optics.p_si_att_db_mm * n * optics.d_mrr_mm
    p -= optics.p_mrm_il_db
    p -= optics.p_splitter_il_db * math.log2(max(m, 2))
    p -= optics.p_mrr_w_il_db
    p -= obl_passes * (n - 1) * optics.p_mrm_obl_db
    p -= penalty_db
    p -= 10.0 * math.log10(n)                  # comb power split over N lambdas
    return p


def obl_passes_for(backend: str) -> int:
    return 1 if backend.replace("_bpca", "") == "heana" else 2


def max_dpe_size(backend: str, bits: float, data_rate_gsps: float,
                 optics: OpticalParams | None = None) -> int:
    """Largest N with P_O/p(N) >= P_PD-opt(bits, DR).  0 if infeasible at N=1.

    P_O/p(N) is strictly decreasing in N, so we binary-search the crossing.
    """
    optics = optics or OpticalParams()
    key = backend.replace("_bpca", "")
    penalty = NETWORK_PENALTY_DB[key]
    obl_passes = obl_passes_for(backend)
    try:
        p_req = noise.p_pd_opt_dbm(bits, data_rate_gsps, optics)
    except ValueError:
        return 0

    def feasible(n: int) -> bool:
        return output_power_dbm(n, n, penalty, optics, obl_passes) >= p_req

    if not feasible(1):
        return 0
    lo, hi = 1, 1
    while hi < MAX_N and feasible(hi):
        lo, hi = hi, hi * 2
    hi = min(hi, MAX_N)
    # invariant: feasible(lo), not feasible(hi) (unless hi == MAX_N feasible)
    if feasible(hi):
        return hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if feasible(mid):
            lo = mid
        else:
            hi = mid
    return lo


def fig9_surface(backends: Iterable[str] = ("amw", "maw", "heana"),
                 bit_range: Iterable[int] = range(1, 9),
                 data_rates: Iterable[float] = (1.0, 5.0, 10.0),
                 optics: OpticalParams | None = None,
                 ) -> Dict[Tuple[str, int, float], int]:
    """The full Fig. 9 surface: N for every (backend, B, DR)."""
    out = {}
    for be in backends:
        for b in bit_range:
            for dr in data_rates:
                out[(be, b, dr)] = max_dpe_size(be, b, dr, optics)
    return out


# Paper Table 2: DPU size and count at 4-bit precision, area-matched to
# HEANA(N=83) with 50 DPUs.  Used by the perf model's equal-area comparison.
PAPER_TABLE2 = {
    # backend: {dr_gsps: (N, dpu_count)}
    "amw":   {1.0: (36, 207), 5.0: (17, 900), 10.0: (12, 1950)},
    "maw":   {1.0: (43, 280), 5.0: (21, 1100), 10.0: (15, 1610)},
    "heana": {1.0: (83, 52), 5.0: (42, 180), 10.0: (30, 320)},
}


def table2_dpu_config(backend: str, data_rate_gsps: float) -> Tuple[int, int]:
    """(N, dpu_count) for the equal-area system evaluation (paper Table 2)."""
    key = backend.replace("_bpca", "")
    return PAPER_TABLE2[key][data_rate_gsps]
