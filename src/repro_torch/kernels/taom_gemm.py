"""Hopper kernel: HEANA TAOM-array GEMM with the BPCA accumulation policy.

Replaces the TPU kernel ``repro.kernels.taom_gemm.taom_gemm_quantized``
(Pallas bodies ``_kernel_analog_carry`` and ``_kernel_chunk_adc``) with a
CUDA C++ kernel for sm_90a, ``csrc/taom_gemm.cu``, built with ``nvcc`` at
first use into ``kernels/_build/`` (``kernels/nvcc.py``) and bound through
a plain C entry point loaded with ``ctypes``.

What it computes: an (M, K) @ (K, D) product of integer-valued float32
operands, with K split into C = ceil(K / N) chunks of N = ``dpe_size``
(one BPD integration cycle each).  Analog carry (HEANA, ``*_bpca``) sums
the chunk psums, adds ``sigma * sqrt(C) * noise[M, D]`` and rounds once
through the ADC over [-adc_fs, adc_fs]; chunk-ADC (AMW, MAW) adds
``sigma * noise[c]`` to each chunk psum, rounds it at ``chunk_fs`` and sums
the rounded chunks.

Bound on this card: memory.  At the main path's shapes (K <= 144,
D <= 64) the kernel moves bytes = 4 * (M*K + K*D + M*D*(1 or C) + M*D)
for 2*M*K*D flops — far below the card's flop/byte balance; with noise
off (``noise=None``, as on the served path) the M*D*(1 or C) noise read
is not made at all.  The design
reads each row of xq once (one block owns an output tile as wide as D, up
to 64 columns), keeps the BPCA accumulator in registers across the chunk
loop (no psum leaves the block), and masks ragged M, D and K edges in its
loads instead of padding operands in memory.

Tiles: a plan's ``(block_m, block_d)`` (``LayerPlan.tile``, sized by the
reference scheduler for the TPU kernel's VMEM and grid steps) maps onto
the kernel's tile by ``kernel_tile``: the tile width is the smallest of
8/16/32/64 columns that covers ``min(D, block_d)``.  ``block_m`` selects
nothing: 256 threads of 2 rows x 4 columns each make the tile 2048 / width
rows high.  Numerics are tile-invariant.

On a CPU tensor the wrapper runs the plain PyTorch version
(``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.core.photonic_gemm import CHUNK_ADC_BACKENDS, detection_sigma
from repro_torch.core.types import PhotonicConfig
from repro_torch.kernels import nvcc

# The reference kernel's lane/sublane rounding: the scheduler's tile
# search uses these so plans equal the reference's field for field.
LANE = 128
SUBLANE = 8

SOURCE = Path(__file__).resolve().parent / "csrc" / "taom_gemm.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler",
              "-fPIC")

_TILE_WIDTHS = (8, 16, 32, 64)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _adc_constants(adc_bits: int, full_scale: float
                   ) -> Tuple[float, float, int]:
    """(step, inv_step, hi) of the mid-tread ADC, as host-side doubles —
    shared by the plain version and the kernel launch."""
    levels = (1 << adc_bits) - 1
    step = 2.0 * max(float(full_scale), 1e-12) / levels
    return step, 1.0 / step, levels // 2 + levels % 2


def adc_round(v: torch.Tensor, adc_bits: int,
              full_scale: float) -> torch.Tensor:
    """Uniform mid-tread ADC over [-fs, fs]: clamp(round(v * inv_step),
    -hi, hi) * step, with ``step``/``inv_step`` computed on the host in
    double precision and entering as float32 constants (as in the
    reference, so a multiply, never a traced division)."""
    step, inv_step, hi = _adc_constants(adc_bits, full_scale)
    return torch.clamp(torch.round(v * inv_step), -hi, hi) * step


def calibrated_adc_fs(k: int, cfg: PhotonicConfig) -> float:
    """Analytic PGA calibration: ~4 sigma of a random-+/- integer dot walk."""
    qmax = float(cfg.qmax)
    return max(qmax ** 2 * math.sqrt(float(max(k, 1))) * (4.0 / 3.0), 1e-6)


def chunk_fs(cfg: PhotonicConfig) -> float:
    """Per-chunk ADC full scale for the AMW/MAW per-psum conversion."""
    qmax = float(cfg.qmax)
    return max(qmax ** 2 * math.sqrt(float(cfg.dpe_size)) * (4.0 / 3.0), 1e-6)


def kernel_tile(d: int, block_d: int) -> int:
    """The kernel's tile width in columns for a GEMM of width ``d`` under a
    plan's ``block_d``."""
    want = max(1, min(int(d), int(block_d)))
    return next((t for t in _TILE_WIDTHS if t >= want), _TILE_WIDTHS[-1])


#: Launches of the CUDA kernel (the plain version does not count);
#: ``chip_smoke.py`` sets it to 0 and reads it to show that the main path
#: ran through the kernel.
LAUNCHES = 0

_LIB = None
_LIB_LOCK = threading.Lock()


def build() -> Tuple[Path, str]:
    """Compile ``csrc/taom_gemm.cu`` (see ``kernels/nvcc.py``)."""
    return nvcc.build(SOURCE, NVCC_FLAGS)


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()[0]))
            fn = lib.taom_gemm_f32
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 +
                           [ctypes.c_float] * 4 +
                           [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def taom_gemm_quantized(xq: torch.Tensor, wq: torch.Tensor,
                        noise: Optional[torch.Tensor], cfg: PhotonicConfig,
                        adc_fs: float, *, block_m: int = 128,
                        block_d: int = 128) -> torch.Tensor:
    """Chunked photonic GEMM on pre-quantized integer-valued f32 operands.

    xq: (M, K); wq: (K, D).  noise: standard normal — (M, D) for analog
    carry, (C, M, D) for chunk-ADC (C = ceil(K / dpe_size)) — or None for
    noise off.  block_m/block_d: a plan's tile (see ``kernel_tile``).
    Returns the integer-unit accumulation (M, D); the caller applies the
    scales.
    """
    global LAUNCHES
    if xq.dim() != 2 or wq.dim() != 2:
        raise ValueError(f"xq and wq must be 2-D, got {tuple(xq.shape)} and "
                         f"{tuple(wq.shape)}")
    m, k = xq.shape
    k2, d = wq.shape
    if k != k2 or m < 1 or k < 1 or d < 1:
        raise ValueError(f"bad GEMM shapes xq {tuple(xq.shape)} @ wq "
                         f"{tuple(wq.shape)}")
    n_chunks = max(1, -(-k // cfg.dpe_size))
    chunk_adc = cfg.backend in CHUNK_ADC_BACKENDS
    want = (n_chunks, m, d) if chunk_adc else (m, d)
    if noise is not None and tuple(noise.shape) != want:
        raise ValueError(f"noise has shape {tuple(noise.shape)}, the "
                         f"{cfg.backend.value} policy needs {want}")
    if xq.device.type == "cpu":
        from repro_torch.kernels import ref
        return ref.taom_gemm_reference(xq, wq, noise, cfg, adc_fs)
    if xq.device.type != "cuda":
        raise ValueError(f"no TAOM kernel for device {xq.device}")
    named = (("xq", xq), ("wq", wq), ("noise", noise))
    for name, t in named:
        if t is None:
            continue
        if t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, xq on {xq.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(m, k, d) >= 2 ** 31 - 1024:
        raise ValueError("GEMM dimension too large for the kernel's 32-bit "
                         "launch arguments")

    sigma = detection_sigma(cfg)
    if chunk_adc:
        coef, fs = sigma, chunk_fs(cfg)
    else:
        coef, fs = sigma * math.sqrt(float(n_chunks)), float(adc_fs)
    step, inv_step, hi = _adc_constants(cfg.adc_bits, fs)
    width = kernel_tile(d, block_d)
    out = torch.empty((m, d), dtype=torch.float32, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = _library().taom_gemm_f32(
        xq.data_ptr(), wq.data_ptr(),
        None if noise is None else noise.data_ptr(), out.data_ptr(),
        m, k, d, cfg.dpe_size, n_chunks, int(chunk_adc), coef, inv_step,
        step, float(hi), width, stream)
    if err != 0:
        raise RuntimeError(f"taom_gemm_f32 launch failed: CUDA error {err} "
                           f"(M={m}, K={k}, D={d}, tile width {width})")
    LAUNCHES += 1
    return out
