"""Photodetection noise model — paper Eqs. 1-2 (adopted from Al-Qadasi et al.).

The balanced photodiode noise-current spectral density (A/sqrt(Hz)):

    beta = sqrt(2 q (R P + I_d) + 4 k T / R_L + R^2 P^2 RIN)
         + sqrt(2 q I_d + 4 k T / R_L)

(the two terms are the two photodiodes of the balanced pair: the signal arm
sees shot + thermal + RIN, the reference arm sees dark-current shot +
thermal).  The effective number of bits resolvable at data-rate DR is the
standard ENOB relation:

    B = (20 log10( R P / (beta sqrt(DR / sqrt(2))) ) - 1.76) / 6.02

These closed forms serve double duty here:
  * scalability.py inverts them for P_PD-opt(B, DR)  (paper Fig. 9), and
  * photonic_gemm.py converts them into a Gaussian noise sigma on the analog
    dot-product value (paper Fig. 5's accuracy/precision surfaces).
"""
from __future__ import annotations

import math

from repro_torch.core.types import K_BOLTZMANN, Q_ELECTRON, OpticalParams, dbm_to_watt


def beta_noise_density(p_pd_watt: float, optics: OpticalParams) -> float:
    """Noise-current spectral density of the balanced pair (A/sqrt(Hz))."""
    r = optics.responsivity
    thermal = 4.0 * K_BOLTZMANN * optics.temperature / optics.r_load
    shot_sig = 2.0 * Q_ELECTRON * (r * p_pd_watt + optics.i_dark)
    rin = (r * p_pd_watt) ** 2 * optics.rin_lin
    shot_ref = 2.0 * Q_ELECTRON * optics.i_dark
    return math.sqrt(shot_sig + thermal + rin) + math.sqrt(shot_ref + thermal)


def noise_current_rms(p_pd_watt: float, data_rate_gsps: float,
                      optics: OpticalParams) -> float:
    """RMS noise current (A) at the receiver for the given data rate."""
    bandwidth = data_rate_gsps * 1e9 / math.sqrt(2.0)
    return beta_noise_density(p_pd_watt, optics) * math.sqrt(bandwidth)


def snr(p_pd_watt: float, data_rate_gsps: float, optics: OpticalParams) -> float:
    """Linear signal-to-noise ratio of a full-scale detection event."""
    signal = optics.responsivity * p_pd_watt
    return signal / noise_current_rms(p_pd_watt, data_rate_gsps, optics)


def enob(p_pd_dbm: float, data_rate_gsps: float, optics: OpticalParams) -> float:
    """Effective number of bits — paper Eq. 1."""
    p = dbm_to_watt(p_pd_dbm)
    s = snr(p, data_rate_gsps, optics)
    if s <= 0.0:
        return -float("inf")
    return (20.0 * math.log10(s) - 1.76) / 6.02


def p_pd_opt_dbm(bits: float, data_rate_gsps: float, optics: OpticalParams,
                 lo_dbm: float = -60.0, hi_dbm: float = 30.0,
                 tol: float = 1e-6) -> float:
    """Invert Eq. 1: minimum PD optical power (dBm) for ``bits`` ENOB.

    ``enob`` is monotonically increasing in power, so bisection is exact.
    """
    if enob(hi_dbm, data_rate_gsps, optics) < bits:
        raise ValueError(
            f"{bits} bits unreachable at DR={data_rate_gsps} GS/s "
            f"below {hi_dbm} dBm")
    lo, hi = lo_dbm, hi_dbm
    while hi - lo > tol:
        mid = 0.5 * (lo + hi)
        if enob(mid, data_rate_gsps, optics) >= bits:
            hi = mid
        else:
            lo = mid
    return hi


def relative_noise_sigma(p_pd_dbm: float, data_rate_gsps: float,
                         optics: OpticalParams) -> float:
    """Gaussian sigma of one detection event, relative to full scale.

    A full-scale analog pulse detected with linear SNR ``s`` carries additive
    noise with sigma = 1/s of full scale.  photonic_gemm scales this to
    integer product units.
    """
    p = dbm_to_watt(p_pd_dbm)
    return 1.0 / snr(p, data_rate_gsps, optics)
