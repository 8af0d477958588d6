"""Hopper kernel: forward flash attention (causal / sliding-window).

Replaces the TPU kernel ``repro.kernels.flash_attention.flash_attention_fwd``
(Pallas body ``_kernel``) with a CUDA C++ kernel for sm_90a,
``csrc/flash_attention.cu``, built with ``nvcc`` at first use into
``kernels/_build/`` (``kernels/nvcc.py``) and bound through a plain C entry
point loaded with ``ctypes``.

What it computes, per (batch * head) row of q, k, v (BH, S, D): softmax
attention with scores q k^T * D**-0.5 in float32, masked scores set to
-1e30 (the causal mask ``kj <= qi``, the window ``kj > qi - window``), an
online softmax over key tiles with float32 running max, sum and
accumulator, and the output ``acc / max(l, 1e-30)`` in q's dtype.

Bound on this card: at the served shapes (D 64, S ~1000, bf16) the work is
~250 flops a byte, so operations bound it, and they must run on the
tensor cores.  The bfloat16 instance does (see the source's header): Q K^T
and P V as wgmma on the bf16 tensor cores, P split into two bf16 terms so
that the reference's float32 P is kept to 2^-17 (1.5x the function's
flops on the tensor cores), K and V streamed by TMA through a ring of
shared-memory stages, a producer warpgroup beside one consumer warpgroup
per 64-row query tile.  With D % 8 != 0 (TMA needs 16-byte strides) or an
input off a 16-byte boundary, the same kernel stages the tiles with plain
loads instead; it is still a launch of the kernel.  The float32 instance
stays on the CUDA cores (tensor cores would round float32 to TF32, which
the float32 contract forbids).  Both loop over only the key tiles that can
hold a valid key — tiles wholly above the diagonal or wholly outside the
window are skipped, which leaves the result unchanged — and take any
S >= 1 and D up to 256.  ``chip_smoke.py`` times the kernel beside its
bound (``flash_bound``: the function's flops at the tensor cores' rate, or
its bytes, whichever is longer) and PyTorch's SDPA.

On a CPU tensor the wrapper runs the plain PyTorch version
(``kernels.ops._flash_blocked``); on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

#: Largest head width the kernel takes, and its query and key tile rows
#: (both instances).
MAX_HEAD = 256
TILE = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Launches of the CUDA kernel (the plain version does not count);
#: ``chip_smoke.py`` sets it to 0 and reads it to show that the served
#: prefill ran through the kernel.
LAUNCHES = 0

_LIB = None
_LIB_LOCK = threading.Lock()


def build() -> Tuple[Path, str]:
    """Compile ``csrc/flash_attention.cu`` (see ``kernels/nvcc.py``)."""
    return nvcc.build(SOURCE, NVCC_FLAGS)


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()[0]))
            fn = lib.flash_attention_fwd
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 +
                           [ctypes.c_float] + [ctypes.c_int] * 3 +
                           [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q, k, v: (BH, S, D), heads folded into the batch axis (K and V
    already expanded per head), all float32 or all bfloat16, contiguous.
    Returns (BH, S, D) in q's dtype."""
    global LAUNCHES
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, S, D), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, q "
                             f"{tuple(q.shape)}")
    bh, s, d = q.shape
    if min(bh, s, d) < 1:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.device.type == "cpu":
        from repro_torch.kernels import ops
        return ops._flash_blocked(q, k, v, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"q, k and v must all be float32 or all "
                            f"bfloat16, got {name} {t.dtype} with q "
                            f"{q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d > MAX_HEAD:
        raise ValueError(f"the kernel takes D <= {MAX_HEAD}, got D={d}")
    if bh * -(-s // TILE) >= 2 ** 31 or max(s, window) >= 2 ** 31:
        raise ValueError("input too large for the kernel's 32-bit launch "
                         "arguments")

    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, d,
        d ** -0.5, int(bool(causal)), int(window), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err} (BH={bh}, S={s}, D={d}, {q.dtype})")
    LAUNCHES += 1
    return o
