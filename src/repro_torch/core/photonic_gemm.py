"""Photonic GEMM numerics simulation — the paper's C1+C3 as a drop-in
matmul (PyTorch counterpart of ``repro.core.photonic_gemm``).

A HEANA / AMW / MAW DPU contracts K in DPE-sized chunks of N =
``cfg.dpe_size``; each chunk psum is an exact integer dot product plus a
Gaussian detection-noise draw whose sigma comes from the link budget at
the operating point (Eqs. 1-3).  HEANA (and the ``*_bpca`` variants)
accrue psums in the analog domain and convert once per output; AMW / MAW
convert every chunk psum; int_quant accumulates exactly; exact is a plain
matmul.

``photonic_dot_general(x, w, cfg)`` is the reference's drop-in matmul:
per-tensor / per-output-channel quantization, the chunked psums, the
backend's accumulation policy with the ADC's full scale taken from the
data (``max |acc|``), the rescale — and a straight-through backward
(gradients of an exact matmul, ``_SteDot``), so that a model trains
through the numerics.  ``device_level_dot`` is the same product made
explicitly through the TAOM lanes and the BPCA (HEANA backends only).
The zoo's GEMM is ``kernels.ops.photonic_matmul`` (a calibrated ADC
scale, the TAOM kernel); this module also holds what it needs: the noise
sigma, the chunk count, and the noise tensor's shape and draws.

Noise draws come from a ``torch.Generator``, or arrive pre-drawn.  They
are not the reference's ``jax.random`` bits: conformance tests hand both
packages the same pre-sampled noise, and the port's sampler is tested
statistically.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import bpca, scalability
from repro_torch.core import taom as taom_mod
from repro_torch.core.taom import quantize
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


def _chunked(q: torch.Tensor, n: int, n_chunks: int,
             axis_last: bool) -> torch.Tensor:
    """Zero-pad K to n_chunks*n and reshape into chunks: (..., K) ->
    (..., C, N) with ``axis_last``, else (K, ...) -> (C, N, ...)."""
    k = q.shape[-1] if axis_last else q.shape[0]
    pad = n_chunks * n - k
    if axis_last:
        if pad:
            q = torch.nn.functional.pad(q, (0, pad))
        return q.reshape(*q.shape[:-1], n_chunks, n)
    if pad:
        q = torch.cat([q, q.new_zeros((pad, *q.shape[1:]))])
    return q.reshape(n_chunks, n, *q.shape[1:])


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _simulate(x: torch.Tensor, w: torch.Tensor, noise: torch.Tensor,
              cfg: PhotonicConfig) -> torch.Tensor:
    """Forward photonic simulation.  noise: standard normal, pre-sampled
    (``noise_shape``).  The scalar factors are float32, as the
    reference's weakly typed scalars are: sigma, and for HEANA
    float32(sigma) * sqrt(float32(C))."""
    if cfg.backend == Backend.EXACT:
        return x @ w
    f32 = torch.float32
    xq, sx = quantize(x.to(f32), cfg.bits, axis=None)             # scalar
    wq, sw = quantize(w.to(f32), cfg.bits, axis=0)                # (1, D)
    n_chunks = num_chunks(x.shape[-1], cfg)
    xc = _chunked(xq, cfg.dpe_size, n_chunks, axis_last=True)     # (...,C,N)
    wc = _chunked(wq, cfg.dpe_size, n_chunks, axis_last=False)    # (C,N,D)
    # One BPD integration cycle per chunk: exact integer psum.
    psums = torch.einsum("...cn,cnd->...cd", xc, wc)              # (...,C,D)
    sigma = _f32(detection_sigma(cfg), psums)
    if cfg.backend == Backend.INT_QUANT:
        total = torch.sum(psums, dim=-2)
    elif cfg.backend in CHUNK_ADC_BACKENDS:
        # AMW/MAW: noise + ADC per chunk, digital reduction.
        noisy = psums + sigma * noise
        fs = noisy.abs().amax()
        total = torch.sum(bpca.adc_readout(noisy, cfg.adc_bits, fs), dim=-2)
    else:
        # HEANA: analog carry across chunks (BPCA), single ADC per output.
        acc = torch.sum(psums, dim=-2)
        acc = acc + sigma * torch.sqrt(_f32(float(n_chunks), acc)) * noise
        fs = acc.abs().amax()
        total = bpca.adc_readout(acc, cfg.adc_bits, fs)
    return (total * (sx * sw)).to(x.dtype)


class _SteDot(torch.autograd.Function):
    """``_simulate`` forward, exact-matmul (straight-through) backward —
    the reference's ``_ste_dot`` custom_vjp."""

    @staticmethod
    def forward(ctx, x, w, noise, cfg):
        ctx.save_for_backward(x, w)
        return _simulate(x, w, noise, cfg)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = torch.einsum("...d,kd->...k", g, w).to(x.dtype)
        batch = list(range(g.dim() - 1))
        gw = torch.tensordot(x, g, dims=(batch, batch)).to(w.dtype)
        return gx, gw, None, None


def _noise_for(x: torch.Tensor, w: torch.Tensor, cfg: PhotonicConfig,
               generator: Optional[torch.Generator],
               noise: Optional[torch.Tensor]) -> torch.Tensor:
    """Pre-drawn ``noise`` (checked), a draw from ``generator`` when the
    config's noise is on, else zeros (deterministic)."""
    want = noise_shape(tuple(x.shape), tuple(w.shape), cfg)
    if noise is not None:
        if tuple(noise.shape) != want:
            raise ValueError(f"noise is {tuple(noise.shape)}, the product "
                             f"needs {want}")
        return noise.to(device=x.device, dtype=torch.float32)
    if generator is not None and cfg.noise_enabled:
        return sample_noise(generator, tuple(x.shape), tuple(w.shape), cfg)
    return torch.zeros(want, dtype=torch.float32, device=x.device)


def photonic_dot_general(x: torch.Tensor, w: torch.Tensor,
                         cfg: PhotonicConfig,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Drop-in matmul with HEANA/AMW/MAW numerics (see module docstring).

    x: (..., K), w: (K, D) -> (..., D).  Detection noise comes pre-drawn
    (``noise``, standard normal of ``noise_shape(x.shape, w.shape, cfg)``)
    or from ``generator`` when ``cfg.noise_enabled``; with neither the
    simulation is deterministic (quantization + accumulation policy
    only).  Differentiable: the backward is an exact matmul's."""
    if cfg.backend == Backend.EXACT:
        return x @ w
    return _SteDot.apply(x, w, _noise_for(x, w, cfg, generator, noise), cfg)


def device_level_dot(x: torch.Tensor, w: torch.Tensor, cfg: PhotonicConfig,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Explicit TAOM -> lanes -> BPCA path (device level, HEANA backends
    only).  Slower but structurally faithful: it pins the fused
    ``photonic_dot_general`` to the device model.  Noise as there (one
    draw per output: ``noise_shape``)."""
    if cfg.backend not in ANALOG_CARRY_BACKENDS:
        raise ValueError(f"device_level_dot models the analog-carry "
                         f"backends {ANALOG_CARRY_BACKENDS}, got "
                         f"{cfg.backend}")
    f32 = torch.float32
    xq, sx = quantize(x.to(f32), cfg.bits, axis=None)
    wq, sw = quantize(w.to(f32), cfg.bits, axis=0)
    n_chunks = num_chunks(x.shape[-1], cfg)
    xc = _chunked(xq, cfg.dpe_size, n_chunks, axis_last=True)   # (...,C,N)
    wc = _chunked(wq, cfg.dpe_size, n_chunks, axis_last=False)  # (C,N,D)
    # Explicit per-wavelength TAOM products on the balanced lanes, then one
    # BPD integration per chunk cycle: (...,C,N,1) * (C,N,D) -> (...,C,N,D).
    through, drop = taom_mod.taom_array_products(xc[..., None], wc, cfg)
    psums = bpca.integrate_cycle(through, drop, axis=-2)          # (...,C,D)
    acc = bpca.accumulate(psums.movedim(-2, -1), cfg=cfg, chunk_axis=-1)
    sigma = detection_sigma(cfg)
    if sigma > 0.0 and (noise is not None or generator is not None):
        draw = _noise_for(x, w, cfg, generator, noise)
        acc = acc + _f32(sigma, acc) * torch.sqrt(
            _f32(float(n_chunks), acc)) * draw
    total = bpca.adc_readout(acc, cfg.adc_bits, acc.abs().amax())
    return (total * (sx * sw)).to(x.dtype)
