"""BPCA — Balanced Photo-Charge Accumulator (paper §3.2.4).

PyTorch counterpart of ``repro.core.bpca``.  A BPCA is a balanced
photodiode pair feeding a time-integrating receiver with a bank of
capacitors: per 1 ns cycle the pair integrates the signed psum of up to N
products, the receiver accrues that charge on a selected capacitor (analog
accumulation across cycles, no per-psum ADC), and one ADC conversion
happens per finished output value.  The capacitor-selection policy is
dataflow dependent but has no numerical effect; it drives the perf model's
event counts.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import noise as noise_mod
from repro_torch.core.types import (BPCA_NUM_CAPACITORS,
                                    OS_COHERENT_PULSES_PER_CYCLE, Dataflow,
                                    PhotonicConfig)


def detection_sigma_int(cfg: PhotonicConfig, p_pd_dbm: float) -> float:
    """Gaussian sigma of one BPD integration cycle, in integer product
    units: the relative noise at the photodiode power times the full-scale
    single-wavelength product qmax^2 (one draw per integration cycle)."""
    sigma_rel = noise_mod.relative_noise_sigma(
        p_pd_dbm, cfg.data_rate_gsps, cfg.optics)
    full_scale = float(cfg.qmax) ** 2
    return full_scale * sigma_rel


def integrate_cycle(through: torch.Tensor, drop: torch.Tensor,
                    axis: int = -1) -> torch.Tensor:
    """One BPD integration: net photocharge of a cycle's pulse ensemble."""
    return torch.sum(through, dim=axis) - torch.sum(drop, dim=axis)


def accumulate(psums: torch.Tensor, *, cfg: PhotonicConfig,
               sigma_int: float = 0.0,
               generator: Optional[torch.Generator] = None,
               chunk_axis: int = -1) -> torch.Tensor:
    """Analog temporal accumulation of per-cycle psums on one capacitor.

    Each cycle contributes an independent detection-noise draw, so the
    capacitor voltage carries noise sigma_int * sqrt(n_chunks).
    """
    del cfg
    total = torch.sum(psums, dim=chunk_axis)
    if generator is not None and sigma_int > 0.0:
        n_chunks = psums.shape[chunk_axis]
        noise = torch.randn(total.shape, generator=generator,
                            dtype=total.dtype, device=total.device)
        total = total + sigma_int * math.sqrt(float(n_chunks)) * noise
    return total


def adc_readout(voltage: torch.Tensor, adc_bits: int,
                full_scale) -> torch.Tensor:
    """Single ADC conversion of the accrued capacitor voltage: 2^adc_bits
    uniform levels across the symmetric range [-FS, FS]."""
    levels = (1 << adc_bits) - 1
    fs = torch.clamp(torch.as_tensor(full_scale, dtype=voltage.dtype,
                                     device=voltage.device), min=1e-12)
    step = 2.0 * fs / levels
    hi = levels // 2 + levels % 2
    return torch.clamp(torch.round(voltage / step), -hi, hi) * step


def capacitor_schedule(dataflow: Dataflow, n_cycles: int,
                       outputs_per_cycle: int = 1) -> Tuple[int, int]:
    """(distinct capacitors used, ADC conversions) over an accumulation
    window: OS holds one capacitor; IS/WS need one per in-flight output,
    bounded by the bank size."""
    if dataflow == Dataflow.OS:
        return 1, 1
    caps = min(n_cycles * outputs_per_cycle, BPCA_NUM_CAPACITORS)
    return caps, n_cycles * outputs_per_cycle


def os_pulses_per_cycle() -> int:
    """OS dataflow: 10x coherent pulse accumulation headroom (§3.2.4)."""
    return OS_COHERENT_PULSES_PER_CYCLE
