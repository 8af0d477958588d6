"""``photonic_matmul``: quantize -> TAOM GEMM -> rescale, with an STE
backward (counterpart of ``repro.kernels.ops.photonic_matmul``).

This is what the model zoo calls.  It folds leading dimensions into the
GEMM's M axis, quantizes both operands, runs the chunked TAOM GEMM —
the Hopper kernel (``kernels/taom_gemm.py``) for CUDA tensors, the plain
version (``kernels/ref.py``) for CPU tensors or when asked — and rescales.
The backward is the straight-through estimator of the reference's
``custom_vjp``: gradients of an exact matmul, ``g @ w.T`` and ``x.T @ g``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.photonic_gemm import CHUNK_ADC_BACKENDS, sample_noise
from repro_torch.core.taom import quantize
from repro_torch.core.types import Backend, PhotonicConfig
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels import taom_gemm as taom_kernel_mod

IMPLS = ("auto", "kernel", "ref")


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def _taom_forward(x2d: torch.Tensor, w: torch.Tensor,
                  noise: Optional[torch.Tensor],
                  cfg: PhotonicConfig, adc_fs: float, impl: str,
                  blocks: tuple) -> torch.Tensor:
    f32 = torch.float32
    xq, sx = quantize(x2d.to(f32), cfg.bits, axis=None)
    wq, sw = quantize(w.to(f32), cfg.bits, axis=0)
    if impl == "kernel":
        acc = taom_kernel_mod.taom_gemm_quantized(
            xq.contiguous(), wq.contiguous(), noise, cfg, adc_fs,
            block_m=blocks[0], block_d=blocks[1])
    else:
        acc = ref_mod.taom_gemm_reference(xq, wq, noise, cfg, adc_fs)
    return (acc * (sx * sw)).to(x2d.dtype)


class _TaomSTE(torch.autograd.Function):
    """Photonic forward, exact-matmul (straight-through) backward."""

    @staticmethod
    def forward(ctx, x2d, w, noise, cfg, adc_fs, impl, blocks):
        ctx.save_for_backward(x2d, w)
        return _taom_forward(x2d, w, noise, cfg, adc_fs, impl, blocks)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        gx = (g @ w.T).to(x2d.dtype) if ctx.needs_input_grad[0] else None
        gw = (x2d.T @ g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw, None, None, None, None, None


def photonic_matmul(x: torch.Tensor, w: torch.Tensor, cfg: PhotonicConfig,
                    generator: Optional[torch.Generator] = None,
                    impl: str = "auto",
                    adc_fs: Optional[float] = None,
                    block_m: int = 128, block_d: int = 128) -> torch.Tensor:
    """Photonic-numerics matmul: (..., K) @ (K, D) -> (..., D).

    impl: 'auto' (the kernel for CUDA tensors, the plain version for CPU
    tensors) | 'kernel' | 'ref'.  adc_fs: calibrated PGA full scale;
    default = analytic calibration.  block_m/block_d: a LayerPlan's tile
    (mapped onto the kernel's own tile; numerics are tile-invariant).

    Noise contract: ``cfg.noise_enabled=True`` requires a ``generator``
    (on x's device); without one this raises — disable noise explicitly
    (``noise_enabled=False``) to run deterministically.  The EXACT backend
    bypasses the photonic pipeline, so ``noise_enabled`` does not apply.
    """
    if cfg.backend == Backend.EXACT:
        return x @ w
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if cfg.noise_enabled and generator is None:
        raise ValueError(
            "photonic_matmul: cfg.noise_enabled=True but generator=None — "
            "detection noise needs a torch.Generator on x's device; or set "
            "noise_enabled=False to run deterministically")
    if impl == "auto":
        impl = "kernel" if x.is_cuda else "ref"
    if adc_fs is None:
        adc_fs = taom_kernel_mod.calibrated_adc_fs(x.shape[-1], cfg)
    batch_shape = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    noise = None                    # noise off: the GEMM skips the term
    if cfg.noise_enabled:
        if not _same_device(generator.device, x.device):
            raise ValueError(f"generator is on {generator.device} but x is "
                             f"on {x.device}")
        noise = sample_noise(generator, tuple(x2d.shape), tuple(w.shape), cfg)
        if cfg.backend in CHUNK_ADC_BACKENDS:
            noise = noise.movedim(-2, 0).contiguous()   # (M,C,D) -> (C,M,D)
    out = _TaomSTE.apply(x2d, w, noise, cfg, float(adc_fs), impl,
                         (int(block_m), int(block_d)))
    return out.reshape(*batch_shape, w.shape[-1])
