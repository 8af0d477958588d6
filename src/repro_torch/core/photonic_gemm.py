"""Photonic GEMM numerics: operating point, noise level and noise draws.

PyTorch counterpart of ``repro.core.photonic_gemm``.  A HEANA / AMW / MAW
DPU contracts K in DPE-sized chunks of N = ``cfg.dpe_size``; each chunk
psum is an exact integer dot product plus a Gaussian detection-noise draw
whose sigma comes from the link budget at the operating point (Eqs. 1-3).
HEANA (and the ``*_bpca`` variants) accrue psums in the analog domain and
convert once per output; AMW / MAW convert every chunk psum.  The GEMM
itself is ``kernels.ops.photonic_matmul``; this module holds what it
needs: the noise sigma, the chunk count, and the noise tensor's shape and
draws.

Noise draws come from a ``torch.Generator``.  They are not the
reference's ``jax.random`` bits: conformance tests hand both packages the
same pre-sampled noise, and the port's sampler is tested statistically.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core import bpca, scalability
from repro_torch.core.types import (NETWORK_PENALTY_DB, Backend,
                                    PhotonicConfig)

ANALOG_CARRY_BACKENDS = (Backend.HEANA, Backend.HEANA_AMW_BPCA,
                         Backend.HEANA_MAW_BPCA)
CHUNK_ADC_BACKENDS = (Backend.AMW, Backend.MAW)

_MASK63 = (1 << 63) - 1


def operating_pd_power_dbm(cfg: PhotonicConfig) -> float:
    """Optical power at the photodiode for the configured DPE size."""
    if cfg.pd_power_dbm is not None:
        return cfg.pd_power_dbm
    key = cfg.backend.value.replace("_bpca", "")
    if key == "exact" or key == "int_quant":
        key = "heana"
    return scalability.output_power_dbm(
        cfg.dpe_size, cfg.dpe_size, NETWORK_PENALTY_DB[key], cfg.optics,
        scalability.obl_passes_for(key))


def detection_sigma(cfg: PhotonicConfig) -> float:
    """Per-cycle detection-noise sigma in integer product units."""
    if not cfg.noise_enabled:
        return 0.0
    return bpca.detection_sigma_int(cfg, operating_pd_power_dbm(cfg))


def design_point(backend: Backend, bits: int, data_rate_gsps: float,
                 **overrides) -> PhotonicConfig:
    """A self-consistent PhotonicConfig at the scalability design point
    (N = max_dpe_size(backend, bits, DR)); N=1 where the precision is
    optically infeasible, as in the reference."""
    from repro_torch.core import hw
    key = backend.value.replace("_bpca", "")
    if scalability.max_dpe_size(key, bits, data_rate_gsps) < 1:
        return PhotonicConfig(backend=backend, bits=bits, dpe_size=1,
                              data_rate_gsps=data_rate_gsps, **overrides)
    op = hw.OperatingPoint.design(backend.value, bits=bits,
                                  data_rate_gsps=data_rate_gsps)
    return op.kernel_config(backend=backend, **overrides)


def num_chunks(k: int, cfg: PhotonicConfig) -> int:
    return max(1, math.ceil(k / cfg.dpe_size))


def noise_shape(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...],
                cfg: PhotonicConfig) -> Tuple[int, ...]:
    """Shape of the pre-sampled standard-normal noise tensor: one draw per
    output element for analog carry, one per (chunk, output) for the
    chunk-ADC backends (noise interacts with the per-chunk rounding)."""
    batch = tuple(x_shape[:-1])
    d = w_shape[-1]
    if cfg.backend in CHUNK_ADC_BACKENDS:
        return (*batch, num_chunks(x_shape[-1], cfg), d)
    return (*batch, d)


def sample_noise(generator: torch.Generator, x_shape: Tuple[int, ...],
                 w_shape: Tuple[int, ...], cfg: PhotonicConfig,
                 dtype=torch.float32) -> torch.Tensor:
    """Standard-normal noise of ``noise_shape`` on the generator's device."""
    return torch.randn(noise_shape(x_shape, w_shape, cfg),
                       generator=generator, dtype=dtype,
                       device=generator.device)


def fold_seed(seed: int, data: int) -> int:
    """Derive an independent seed from (seed, data) — the port's stand-in
    for ``jax.random.fold_in``: a SplitMix64 finaliser over both values,
    so neighbouring layer or chunk indices get unrelated streams."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(data) + 1) & ((1 << 64) - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (z ^ (z >> 31)) & _MASK63


def generator_for(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen
