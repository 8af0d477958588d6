"""Hopper kernels: HEANA TAOM-array GEMM with the BPCA accumulation policy.

Replaces the TPU kernel ``repro.kernels.taom_gemm.taom_gemm_quantized``
(Pallas bodies ``_kernel_analog_carry`` and ``_kernel_chunk_adc``) with
CUDA C++ kernels for sm_90a, ``csrc/taom_gemm.cu``, built with ``nvcc`` at
first use into ``kernels/_build/`` (``kernels/nvcc.py``) and bound through
plain C entry points loaded with ``ctypes``.

What the TPU kernel computes: an (M, K) @ (K, D) product of
integer-valued float32 operands, with K split into C = ceil(K / N) chunks
of N = ``dpe_size`` (one BPD integration cycle each).  Analog carry
(HEANA, ``*_bpca``) sums the chunk psums, adds ``sigma * sqrt(C) *
noise[M, D]`` and rounds once through the ADC over [-adc_fs, adc_fs];
chunk-ADC (AMW, MAW) adds ``sigma * noise[c]`` to each chunk psum, rounds
it at ``chunk_fs`` and sums the rounded chunks.

Two routes:

* ``taom_gemm_fused`` (operands of at most 7 bits, ``int8_route``): the
  whole of ``ops._taom_forward`` — quantize x per tensor and w per column,
  the chunked GEMM, rescale and cast — in two launches,
  ``taom_gemm_absmax_kernel`` (partial maxima of |x|, w's column scales,
  w quantized once to s8 into a scratch buffer) and
  ``taom_gemm_int8_kernel`` (x quantized on load into shared memory as
  s8, w's pieces copied in with cp.async, exact s8 x s8 -> s32
  tensor-core products per chunk, the policy, rescale and cast in the
  epilogue).  x is float32 or bfloat16, and so is the output.
* ``taom_gemm_quantized`` (any bits; the route for 8-bit operands): the
  float32 body on pre-quantized operands; the caller quantizes and
  rescales.

Bound on this card: memory.  At the main paths' shapes a GEMM reads x and
w and writes its output once (and reads the noise when it is on), and
its 2*M*K*D operations at the int8 tensor-core rate take less time than
those bytes.  The fused route keeps the ~16 elementwise passes of the
unfused route (quantize, rescale) out of device memory; see the source.

Tiles: a plan's ``(block_m, block_d)`` (``LayerPlan.tile``, sized by the
reference scheduler for the TPU kernel's VMEM and grid steps) maps onto
the kernel's tile width by ``kernel_tile``: the smallest of 8/16/32/64
columns that covers ``min(D, block_d)``.  ``block_m`` selects nothing.
The float32 body's tile is 2048 / width rows high (256 threads of 2 rows
x 4 columns); the int8 route's height is ``int8_plan``'s choice.
Numerics are tile-invariant.

On a CPU tensor each wrapper runs its plain PyTorch version
(``kernels/ref.py``); on a CUDA tensor it launches its kernels or raises.
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

# The int8 route (csrc/taom_gemm.cu, taom_gemm_int8).
INT8_QMAX = 127                     # |q| <= qmax fits s8 for bits <= 7
KERNELS = ("taom_gemm_absmax", "taom_gemm_int8")   # its two kernels
INT8_TILE_WIDTHS = (8, 16, 32, 64, 128)
_WARPS = (4, 2, 1)                  # a warp owns 16 rows of the tile
MIN_BLOCKS = 2 * 132                # two blocks for each of the 132 SMs
SLOT_MAX = 192                      # K positions staged at once
ABSMAX_BLOCKS = 132                 # at most, for the partial maxima of |x|
QUANT_EPS = 1e-12                   # core.taom.quantize's eps


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


def int8_route(cfg: PhotonicConfig) -> bool:
    """Whether ``cfg``'s quantized operands fit s8 (bits <= 7): the fused
    int8 route takes them; 8-bit operands take the float32 body."""
    return cfg.qmax <= INT8_QMAX


def int8_plan(m: int, k: int, d: int, n: int, block_d: int = 128) -> dict:
    """Launch shape of the int8 route for an (M, K) @ (K, D) GEMM with
    chunks of N: the tile width (the smallest of ``INT8_TILE_WIDTHS`` that
    covers ``min(D, block_d)``), row warps per block (the most of 4, 2, 1
    that still gives ``MIN_BLOCKS`` blocks, else 1; 16 rows each, and two
    warps side by side at width 128), the tile's height, the grid, the K
    positions staged at once (a chunk, padded to a multiple of 32, at most
    ``SLOT_MAX``), the absmax kernel's blocks, and the bytes of one
    quantized column of w in the scratch buffer (its C chunks, each cut
    into pieces of ``slot`` positions and padded with zeros) and of the
    whole buffer."""
    want = max(1, min(int(d), int(block_d)))
    width = next((t for t in INT8_TILE_WIDTHS if t >= want),
                 INT8_TILE_WIDTHS[-1])
    d_tiles = -(-d // width)
    warps = next((w for w in _WARPS
                  if -(-m // (16 * w)) * d_tiles >= MIN_BLOCKS), 1)
    threads = 1024 if k > 256 else 256      # as the C entry point picks
    x_blocks = max(1, min(ABSMAX_BLOCKS, -(-(m * k) // (threads * 16))))
    slot = min(_round_up(min(n, k), 32), SLOT_MAX)
    w_bytes = -(-k // n) * -(-n // slot) * slot
    return {"width": width, "warps": warps, "tile_m": 16 * warps,
            "grid": (-(-m // (16 * warps)), d_tiles),
            "slot": slot, "x_blocks": x_blocks,
            "w_bytes": w_bytes,
            "scratch_bytes": d * w_bytes + 4 * (x_blocks + d)}


#: Launches of the CUDA kernels: +1 per wrapper call that launches (either
#: route; the plain versions do not count).  ``chip_smoke.py`` sets it to 0
#: and reads it to show that the main path ran through the kernels.
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
            fn = lib.taom_gemm_int8
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 +
                           [ctypes.c_float] * 7 + [ctypes.c_int] * 6 +
                           [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _check_shapes(x, w, noise, cfg):
    """(M, K, D, C, chunk_adc) of a GEMM; raises on bad shapes."""
    (xn, xt), (wn, wt) = x, w
    if xt.dim() != 2 or wt.dim() != 2:
        raise ValueError(f"{xn} and {wn} must be 2-D, got "
                         f"{tuple(xt.shape)} and {tuple(wt.shape)}")
    m, k = xt.shape
    k2, d = wt.shape
    if k != k2 or m < 1 or k < 1 or d < 1:
        raise ValueError(f"bad GEMM shapes {xn} {tuple(xt.shape)} @ {wn} "
                         f"{tuple(wt.shape)}")
    n_chunks = max(1, -(-k // cfg.dpe_size))
    chunk_adc = cfg.backend in CHUNK_ADC_BACKENDS
    want = (n_chunks, m, d) if chunk_adc else (m, d)
    if noise is not None and tuple(noise.shape) != want:
        raise ValueError(f"noise has shape {tuple(noise.shape)}, the "
                         f"{cfg.backend.value} policy needs {want}")
    if max(m, k, d) >= 2 ** 31 - 1024:
        raise ValueError("GEMM dimension too large for the kernel's 32-bit "
                         "launch arguments")
    return m, k, d, n_chunks, chunk_adc


def _check_cuda(named) -> None:
    """Each (name, tensor or None, dtypes) lies on the first one's CUDA
    device, has one of its dtypes and is contiguous."""
    dev = named[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"no TAOM kernel for device {dev}")
    for name, t, dtypes in named:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {named[0][0]} on "
                             f"{dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be "
                            f"{' or '.join(str(x)[6:] for x in dtypes)}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _policy_constants(cfg: PhotonicConfig, adc_fs: float, n_chunks: int):
    """(coef, step, inv_step, hi) of the policy's noise term and ADC."""
    sigma = detection_sigma(cfg)
    if cfg.backend in CHUNK_ADC_BACKENDS:
        coef, fs = sigma, chunk_fs(cfg)
    else:
        coef, fs = sigma * math.sqrt(float(n_chunks)), float(adc_fs)
    step, inv_step, hi = _adc_constants(cfg.adc_bits, fs)
    return coef, step, inv_step, hi


def taom_gemm_quantized(xq: torch.Tensor, wq: torch.Tensor,
                        noise: Optional[torch.Tensor], cfg: PhotonicConfig,
                        adc_fs: float, *, block_m: int = 128,
                        block_d: int = 128) -> torch.Tensor:
    """Chunked photonic GEMM on pre-quantized integer-valued f32 operands
    (the float32 body).

    xq: (M, K); wq: (K, D).  noise: standard normal — (M, D) for analog
    carry, (C, M, D) for chunk-ADC (C = ceil(K / dpe_size)) — or None for
    noise off.  block_m/block_d: a plan's tile (see ``kernel_tile``).
    Returns the integer-unit accumulation (M, D); the caller applies the
    scales.
    """
    global LAUNCHES
    m, k, d, n_chunks, chunk_adc = _check_shapes(("xq", xq), ("wq", wq),
                                                 noise, cfg)
    if xq.device.type == "cpu":
        from repro_torch.kernels import ref
        return ref.taom_gemm_reference(xq, wq, noise, cfg, adc_fs)
    _check_cuda((("xq", xq, (torch.float32,)), ("wq", wq, (torch.float32,)),
                 ("noise", noise, (torch.float32,))))
    coef, step, inv_step, hi = _policy_constants(cfg, adc_fs, n_chunks)
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


def taom_gemm_fused(x: torch.Tensor, w: torch.Tensor,
                    noise: Optional[torch.Tensor], cfg: PhotonicConfig,
                    adc_fs: float, *, block_m: int = 128,
                    block_d: int = 128) -> torch.Tensor:
    """The int8 route: quantize -> chunked photonic GEMM -> rescale, as
    ``ref.photonic_gemm_reference`` computes it, for ``cfg.qmax <= 127``.

    x: (M, K) float32 or bfloat16; w: (K, D) float32 or bfloat16; both
    contiguous.  noise as in ``taom_gemm_quantized``.  block_m/block_d: a
    plan's tile (see ``kernel_tile``).  Returns (M, D) in x's dtype.
    """
    global LAUNCHES
    if not int8_route(cfg):
        raise ValueError(f"the int8 route takes bits <= 7 (qmax <= "
                         f"{INT8_QMAX}), got bits={cfg.bits}")
    m, k, d, n_chunks, chunk_adc = _check_shapes(("x", x), ("w", w), noise,
                                                 cfg)
    if x.device.type == "cpu":
        from repro_torch.kernels import ref
        return ref.photonic_gemm_reference(x, w, noise, cfg, adc_fs)
    kinds = (torch.float32, torch.bfloat16)
    _check_cuda((("x", x, kinds), ("w", w, kinds),
                 ("noise", noise, (torch.float32,))))
    plan = int8_plan(m, k, d, cfg.dpe_size, block_d)
    if plan["grid"][1] > 65535:
        raise ValueError(f"D={d} needs more than 65535 column tiles")
    coef, step, inv_step, hi = _policy_constants(cfg, adc_fs, n_chunks)
    qmax = float(cfg.qmax)
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().taom_gemm_int8(
        x.data_ptr(), w.data_ptr(),
        None if noise is None else noise.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), int(x.dtype == torch.bfloat16),
        int(w.dtype == torch.bfloat16), m, k, d, cfg.dpe_size, n_chunks,
        int(chunk_adc), coef, inv_step, step, float(hi), qmax, 1.0 / qmax,
        QUANT_EPS, plan["width"], plan["warps"], plan["slot"],
        plan["x_blocks"], plan["w_bytes"], int(x.data_ptr() % 16 == 0),
        stream)
    if err != 0:
        raise RuntimeError(f"taom_gemm_int8 launch failed: CUDA error {err} "
                           f"(M={m}, K={k}, D={d}, plan {plan})")
    LAUNCHES += 1
    return out
