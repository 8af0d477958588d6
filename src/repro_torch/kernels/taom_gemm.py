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

Three routes, one chosen by ``taom_route``:

* ``"int8"`` (operands of at most 7 bits: |q| <= 127 fits s8) and
  ``"s8x2"`` (8 bits, with ``dpe_size * qmax^2 < 2^24``), both through
  ``taom_gemm_fused``: the whole of ``ops._taom_forward`` — quantize x per
  tensor and w per column, the chunked GEMM, rescale and cast — in two
  launches, or three: ``taom_gemm_absmax_kernel`` (partial maxima of |x|,
  w's column scales, w quantized once into s8 planes in a scratch
  buffer), where the GEMM has several column tiles or K four pieces
  ``taom_gemm_quant_x_kernel`` (x quantized once into s8 planes;
  ``int8_plan``'s ``x_once``), and ``taom_gemm_int8_kernel`` (x quantized
  on load into shared memory, or its planes copied in; w's pieces copied
  in with cp.async; exact s8 x s8 -> s32 tensor-core products per chunk,
  the policy, rescale and cast in the epilogue) — or, for chunks of at
  most ``SMALL_N`` positions, ``taom_gemm_small_kernel`` (the same on the
  CUDA cores, each chunk's N products summed in s32, where a 32-deep
  tensor-core slot a chunk would waste most of its work).  ``"int8"`` is
  one s8 plane; ``"s8x2"`` splits each q in [-255, 255] into two, q = 16
  h + l with h in [-16, 15] and l in [0, 15], four products a chunk,
  combined exactly in s32 (the source proves it).  x is float32 or
  bfloat16, and so is the output.  x may also be a convolution's windows
  (``windows``: the NHWC input and the geometry; implicit im2col): the
  absmax kernel then reduces |x| over the input pixels some window covers
  (``covered_axis``), and the quantize-x kernel, always launched, gathers
  each window's elements from the input, in the im2col matrix's K order
  (``window_plan``); no float32 matrix is written.
* ``"float32"`` (bits >= 9, or 8 bits at ``dpe_size >= 259``):
  ``taom_gemm_quantized``, the float32 body on pre-quantized operands; the
  caller quantizes and rescales.

Bound on this card: memory at the main paths' shapes (a GEMM reads x and
w and writes its output once, and reads the noise when it is on), except
at QAT's 8-bit widths, where 2*M*K*D operations at the bf16 tensor-core
rate are the larger (``"s8x2"``'s own floor, four s8 products each, is
twice that).  The fused route keeps the ~16 elementwise passes of the
unfused route (quantize, rescale) out of device memory; see the source.

Tiles: a plan's ``(block_m, block_d)`` (``LayerPlan.tile``, sized by the
reference scheduler for the TPU kernel's VMEM and grid steps) maps onto
the kernel's tile width by ``kernel_tile``: the smallest of 8/16/32/64
columns that covers ``min(D, block_d)``.  ``block_m`` selects nothing.
The float32 body's tile is 2048 / width rows high (256 threads of 2 rows
x 4 columns); the fused route's height is ``int8_plan``'s choice.
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

# The fused route (csrc/taom_gemm.cu, taom_gemm_int8).
INT8_QMAX = 127                     # |q| <= qmax fits s8 for bits <= 7
S8X2_QMAX = 255                     # two s8 planes hold |q| <= 255
EXACT_LIMIT = 2 ** 24               # float32 holds every integer below
ROUTES = ("int8", "s8x2", "float32")
# Its kernels: absmax, the optional quantize of x, the tensor-core GEMM or
# the small-chunk kernel.
KERNELS = ("taom_gemm_absmax", "taom_gemm_quant_x", "taom_gemm_int8",
           "taom_gemm_small")
INT8_TILE_WIDTHS = (8, 16, 32, 64, 128)
_WARPS = (4, 2, 1)                  # a warp owns 16 rows of the tile
MIN_BLOCKS = 2 * 132                # two blocks for each of the 132 SMs
SLOT_MAX = 192                      # K positions staged at once
ABSMAX_BLOCKS = 132                 # at most, for the partial maxima of |x|
QUANT_EPS = 1e-12                   # core.taom.quantize's eps
SMALL_N = 8                         # chunks this short take the CUDA cores
X_ONCE_PIECES = 4                   # with one column tile, K pieces from
                                    # which x is quantized once
SMALL_TILE_WIDTHS = (8, 16, 32)     # the small-chunk kernel's tile widths
SMALL_THREADS = 256                 # its block
WINDOW_TABLE_BYTES = 48 * 1024      # quantize-x's table of a row's staged
                                    # positions, reading windows


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


def taom_route(cfg: PhotonicConfig) -> str:
    """The route ``cfg``'s GEMMs take on the card (``ROUTES``): ``"int8"``
    where the quantized operands fit s8 (bits <= 7); ``"s8x2"`` where they
    fit two s8 planes (qmax <= 255: 8 bits) and a chunk's psum stays below
    2^24 (``dpe_size * qmax^2 < 2^24``: N <= 258), so that its s32 sum
    converted once is the reference's float32 chunk dot product;
    ``"float32"`` (the float32 body) otherwise."""
    if cfg.qmax <= INT8_QMAX:
        return "int8"
    if cfg.qmax <= S8X2_QMAX and cfg.dpe_size * cfg.qmax ** 2 < EXACT_LIMIT:
        return "s8x2"
    return "float32"


def int8_plan(m: int, k: int, d: int, n: int, block_d: int = 128,
              planes: int = 1, x_once: Optional[bool] = None,
              small: Optional[bool] = None,
              x_elems: Optional[int] = None) -> dict:
    """Launch shape of the fused route for an (M, K) @ (K, D) GEMM with
    chunks of N and ``planes`` s8 planes an operand (1: ``"int8"``, 2:
    ``"s8x2"``).

    ``small`` (by default, and at most, N <= ``SMALL_N``: on a Table-4
    forward the small kernel was faster than the slot path at N 2, 4 and 8
    at 7 and 8 bits, slower at 32, and at 16 slower for analog carry and
    faster for chunk-ADC): the small-chunk kernel on the CUDA cores; its
    tile is the smallest of ``SMALL_TILE_WIDTHS`` that
    covers ``min(D, block_d)``, each of its 256 threads owns ``height``
    rows (2 where that still gives ``MIN_BLOCKS`` blocks, else 1) of one
    column, and w's planes are compact (``slot`` N, one piece a chunk).
    Otherwise the tensor-core GEMM: the tile width (the smallest of
    ``INT8_TILE_WIDTHS`` that covers ``min(D, block_d)``), row warps per
    block (``warps`` = ``height``: the most of 4, 2, 1 that still gives
    ``MIN_BLOCKS`` blocks, else 1; 16 rows each, and two warps side by side
    at width 128), the K positions staged at once (``slot``: a chunk,
    padded to a multiple of 32, at most ``SLOT_MAX``), and whether x is
    quantized once into planes of the staged layout (``x_once``: by
    default where the grid has more than one column tile or K has at
    least ``X_ONCE_PIECES`` pieces, and the layout at most doubles K;
    otherwise each column tile quantizes its x rows on load, piece by
    piece).  Both: the tile's height in rows, the grid, the absmax
    kernel's blocks (for the ``x_elems`` elements of x it reads, by
    default M K), the bytes of one quantized row of a plane in the
    staged layout (its C chunks, each cut into pieces of ``slot``
    positions and padded with zeros), and the bytes of the scratch buffer:
    w's planes, x's (``x_once``), the partial maxima and the column
    scales, each region rounded up to 16 bytes."""
    if small is None:
        small = n <= SMALL_N
    if small and n > SMALL_N:
        raise ValueError(f"the small-chunk kernel takes dpe_size <= "
                         f"{SMALL_N}, got {n}")
    want = max(1, min(int(d), int(block_d)))
    widths = SMALL_TILE_WIDTHS if small else INT8_TILE_WIDTHS
    width = next((t for t in widths if t >= want), widths[-1])
    d_tiles = -(-d // width)
    if small:
        per_pass = SMALL_THREADS // width
        height = 2 if -(-m // (2 * per_pass)) * d_tiles >= MIN_BLOCKS else 1
        tile_m, warps = per_pass * height, SMALL_THREADS // 32
        slot = n
        x_once = False
    else:
        height = warps = next((w for w in _WARPS
                               if -(-m // (16 * w)) * d_tiles >= MIN_BLOCKS),
                              1)
        tile_m = 16 * warps
        slot = min(_round_up(min(n, k), 32), SLOT_MAX)
    threads = 1024 if k > 256 else 256      # as the C entry point picks
    x_elems = m * k if x_elems is None else x_elems
    x_blocks = max(1, min(ABSMAX_BLOCKS, -(-x_elems // (threads * 16))))
    w_bytes = -(-k // n) * -(-n // slot) * slot
    if x_once is None:
        x_once = ((d_tiles > 1 or w_bytes // slot >= X_ONCE_PIECES) and
                  w_bytes <= 2 * k)
    return {"width": width, "warps": warps, "tile_m": tile_m,
            "grid": (-(-m // tile_m), d_tiles), "height": height,
            "small": bool(small), "slot": slot, "x_blocks": x_blocks,
            "w_bytes": w_bytes, "planes": planes, "x_once": bool(x_once),
            "scratch_bytes": _round_up(planes * d * w_bytes, 16) +
            _round_up(planes * m * w_bytes, 16) * bool(x_once) +
            4 * (x_blocks + d)}


def covered_axis(size: int, k: int, stride: int, before: int,
                 out: int) -> Tuple[int, int, int, int]:
    """The positions along one axis of a convolution's input that some
    window covers, windows o < ``out`` covering [o * stride - before, + k):
    (count, run, period, off), position t < count standing for (t // run)
    * period + t % run - off, those outside [0, size) left out.  Where k >=
    stride the windows tile one run from 0; else each covers a run of k
    positions, ``stride`` apart."""
    if k >= stride:
        hi = min(size, (out - 1) * stride - before + k)
        return hi, hi, 0, 0
    return out * k, k, stride, before


def window_plan(x_shape: Tuple[int, int, int, int],
                windows: Tuple[int, ...], d: int, n: int,
                block_d: int = 128, planes: int = 1) -> Optional[dict]:
    """``int8_plan`` of a GEMM whose x is a convolution's windows
    (``taom_gemm_fused``'s ``windows``) on the NHWC input of ``x_shape``:
    x quantized once, by the kernel that gathers the windows, and the
    absmax kernel's blocks sized from the covered pixels.  None where the
    route cannot read windows: the small-chunk kernel (it reads x as a
    matrix), a staged layout more than twice K (``x_once``'s own
    condition), or past what the quantize-x kernel's table of a row's
    staged positions holds (``WINDOW_TABLE_BYTES`` of shared memory; a
    window of at most 15 x 15, its last element less than 2^24 elements
    from its first)."""
    images, h, w, c = x_shape
    kh, kw, stride, top, left, oh, ow = windows
    m, k = images * oh * ow, kh * kw * c
    cover = (covered_axis(h, kh, stride, top, oh)[0] *
             covered_axis(w, kw, stride, left, ow)[0])
    plan = int8_plan(m, k, d, n, block_d, planes=planes, x_once=True,
                     x_elems=images * cover * c)
    if (plan["small"] or plan["w_bytes"] > 2 * k or
            4 * plan["w_bytes"] > WINDOW_TABLE_BYTES or max(kh, kw) > 15 or
            ((kh - 1) * w + kw) * c > 2 ** 24):
        return None
    return plan


#: Launches of the CUDA kernels: +1 per wrapper call that launches (any
#: route; the plain versions do not count), and per route in
#: ``ROUTE_LAUNCHES``.  ``chip_smoke.py`` sets them to 0 and reads them to
#: show that the main path ran through the kernels.  ``OPERAND_LAUNCHES``
#: counts the fused route's calls by the form its x came in (``OPERANDS``):
#: a convolution's input viewed as the matrix (1x1, stride 1), its
#: windows, or a matrix in device memory.
LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
OPERANDS = ("view", "implicit", "matrix")
OPERAND_LAUNCHES = dict.fromkeys(OPERANDS, 0)

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
                           [ctypes.c_float] * 7 + [ctypes.c_int] * 9 +
                           [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _check_shapes(x, w, noise, cfg):
    """(M, K, D, C, chunk_adc) of a GEMM; raises on bad shapes.  x and w:
    (name, shape)."""
    (xn, xs), (wn, ws) = x, w
    xs, ws = tuple(xs), tuple(ws)
    if len(xs) != 2 or len(ws) != 2:
        raise ValueError(f"{xn} and {wn} must be 2-D, got {xs} and {ws}")
    m, k = xs
    k2, d = ws
    if k != k2 or m < 1 or k < 1 or d < 1:
        raise ValueError(f"bad GEMM shapes {xn} {xs} @ {wn} {ws}")
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
    m, k, d, n_chunks, chunk_adc = _check_shapes(
        ("xq", xq.shape), ("wq", wq.shape), noise, cfg)
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
    ROUTE_LAUNCHES["float32"] += 1
    return out


def taom_gemm_fused(x: torch.Tensor, w: torch.Tensor,
                    noise: Optional[torch.Tensor], cfg: PhotonicConfig,
                    adc_fs: float, *, block_m: int = 128,
                    block_d: int = 128, windows: Optional[tuple] = None,
                    operand: str = "matrix",
                    _plan: Optional[dict] = None) -> torch.Tensor:
    """The fused route (``"int8"`` or ``"s8x2"``, ``taom_route``): quantize
    -> chunked photonic GEMM -> rescale, as ``ref.photonic_gemm_reference``
    computes it.

    x: (M, K) float32 or bfloat16; w: (K, D) float32 or bfloat16; both
    contiguous.  ``windows``: x is instead a convolution's NHWC input (N,
    H, W, C), on the card, and the GEMM's x is the im2col matrix of its
    windows, ``(kh, kw, stride, pad top, pad left, OH, OW)`` (window (oy,
    ox)'s position (i, j) reads row oy * stride + i - top and column ox *
    stride + j - left, zero outside the image; M = N OH OW, K = kh kw C in
    window-position-major, channel-minor order), which the kernels read
    without writing it (``window_plan``; it raises where that plan is
    None).  ``operand``: how the caller's 2-D x came to be, ``"view"`` or
    ``"matrix"``, counted in ``OPERAND_LAUNCHES`` (``windows`` counts as
    ``"implicit"``).  noise as in ``taom_gemm_quantized``.
    block_m/block_d: a plan's tile (see ``kernel_tile``).  ``_plan``: an
    ``int8_plan`` of this GEMM to launch instead of the default one
    (tests and measurements force ``x_once`` or ``small`` with it).
    Returns (M, D) in x's dtype.
    """
    global LAUNCHES
    route = taom_route(cfg)
    if route == "float32":
        raise ValueError(f"the fused route takes bits <= 7 (qmax <= "
                         f"{INT8_QMAX}, one s8 plane), or 8 bits with "
                         f"dpe_size * qmax^2 < 2^24 (two planes); got "
                         f"bits={cfg.bits}, dpe_size={cfg.dpe_size}")
    if operand not in OPERANDS:
        raise ValueError(f"operand must be one of {OPERANDS}, got "
                         f"{operand!r}")
    x_shape = tuple(x.shape)
    if windows is not None:
        if x.dim() != 4 or len(windows) != 7:
            raise ValueError(f"windows take an (N, H, W, C) x and (kh, kw, "
                             f"stride, top, left, OH, OW), got "
                             f"{x_shape} and {windows}")
        kh, kw, _, _, _, oh, ow = windows
        x_shape = (x.shape[0] * oh * ow, kh * kw * x.shape[3])
        operand = "implicit"
    m, k, d, n_chunks, chunk_adc = _check_shapes(("x", x_shape),
                                                 ("w", w.shape), noise, cfg)
    if x.device.type == "cpu":
        if windows is not None:
            raise ValueError("the kernels read windows on the card; on the "
                             "CPU pass the im2col matrix")
        from repro_torch.kernels import ref
        return ref.photonic_gemm_reference(x, w, noise, cfg, adc_fs)
    kinds = (torch.float32, torch.bfloat16)
    _check_cuda((("x", x, kinds), ("w", w, kinds),
                 ("noise", noise, (torch.float32,))))
    planes = 1 if route == "int8" else 2
    conv = None
    if windows is not None:
        plan = _plan or window_plan(tuple(x.shape), windows, d, cfg.dpe_size,
                                    block_d, planes)
        if plan is None:
            raise ValueError(f"the fused route cannot read windows {windows} "
                             f"of {tuple(x.shape)} at dpe_size "
                             f"{cfg.dpe_size}: pass the im2col matrix")
        images, h, wd, c = x.shape
        kh, kw, stride, top, left, oh, ow = windows
        conv = (ctypes.c_int * 19)(
            images, h, wd, c, kh, kw, stride, top, left, oh, ow,
            *covered_axis(h, kh, stride, top, oh),
            *covered_axis(wd, kw, stride, left, ow))
    else:
        plan = _plan or int8_plan(m, k, d, cfg.dpe_size, block_d,
                                  planes=planes)
    if plan["planes"] != planes:
        raise ValueError(f"the {route} route takes {planes} s8 plane(s), "
                         f"the plan has {plan['planes']}")
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
        QUANT_EPS, plan["width"], plan["height"], plan["slot"],
        plan["x_blocks"], plan["w_bytes"], int(x.data_ptr() % 16 == 0),
        plan["planes"], int(plan["x_once"]), int(plan["small"]), conv,
        stream)
    if err != 0:
        raise RuntimeError(f"taom_gemm_int8 launch failed: CUDA error {err} "
                           f"(M={m}, K={k}, D={d}, plan {plan}, windows "
                           f"{windows})")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    OPERAND_LAUNCHES[operand] += 1
    return out
