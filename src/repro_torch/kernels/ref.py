"""Plain PyTorch versions of the port's kernels.

``taom_gemm_reference`` is the plain version of
``kernels.taom_gemm.taom_gemm_quantized`` (counterpart of
``repro.kernels.ref.taom_gemm_reference``): it takes the same explicit
inputs as the kernel (pre-quantized operands, pre-sampled noise,
calibrated ADC scale), chunks K at the exact dpe_size, and shares the
kernel's ADC constants (``adc_round``).  The CPU tests run it against the
reference package; ``chip_smoke.py`` holds the CUDA kernel against it on
the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.photonic_gemm import CHUNK_ADC_BACKENDS, detection_sigma
from repro_torch.core.types import PhotonicConfig
from repro_torch.kernels.taom_gemm import adc_round, chunk_fs


def _sum_chunks(t: torch.Tensor) -> torch.Tensor:
    """Sum over the leading chunk axis in chunk order (0 + t0 + t1 + ...),
    the order the kernel accumulates in."""
    acc = t[0]
    for c in range(1, t.shape[0]):
        acc = acc + t[c]
    return acc


def taom_gemm_reference(xq: torch.Tensor, wq: torch.Tensor,
                        noise: Optional[torch.Tensor], cfg: PhotonicConfig,
                        adc_fs: float) -> torch.Tensor:
    """Plain version of kernels.taom_gemm.taom_gemm_quantized (noise None:
    noise off, the noise term left out)."""
    m, k = xq.shape
    _, d = wq.shape
    n = cfg.dpe_size
    n_chunks = max(1, -(-k // n))
    kp = n_chunks * n - k
    x = F.pad(xq.to(torch.float32), (0, kp))
    w = F.pad(wq.to(torch.float32), (0, 0, 0, kp))
    xc = x.reshape(m, n_chunks, n).transpose(0, 1)            # (C, M, N)
    wc = w.reshape(n_chunks, n, d)                            # (C, N, D)
    psums = torch.bmm(xc, wc)                                 # (C, M, D)
    sigma = detection_sigma(cfg)
    if cfg.backend in CHUNK_ADC_BACKENDS:
        if noise is not None:
            if tuple(noise.shape) != (n_chunks, m, d):
                raise ValueError(f"noise {tuple(noise.shape)} != "
                                 f"{(n_chunks, m, d)}")
            psums = psums + sigma * noise
        return _sum_chunks(adc_round(psums, cfg.adc_bits, chunk_fs(cfg)))
    acc = _sum_chunks(psums)
    if noise is not None:
        if tuple(noise.shape) != (m, d):
            raise ValueError(f"noise {tuple(noise.shape)} != {(m, d)}")
        acc = acc + sigma * math.sqrt(float(n_chunks)) * noise
    return adc_round(acc, cfg.adc_bits, float(adc_fs))
