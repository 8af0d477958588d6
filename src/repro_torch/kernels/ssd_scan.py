"""Hopper kernel: Mamba2 SSD (state-space duality) chunked scan.

Replaces the TPU kernel ``repro.kernels.ssd_scan.ssd_scan_chunked``
(Pallas body ``_ssd_kernel``) with a CUDA C++ kernel for sm_90a,
``csrc/ssd_scan.cu``, built with ``nvcc`` at first use into
``kernels/_build/`` (``kernels/nvcc.py``) and bound through a plain C entry
point loaded with ``ctypes``.

What it computes, per sequence of the flattened (batch * head) axis and
chunk of Q steps, with cum = cumsum(dt * a) over the chunk: the causal
intra-chunk term (C B^T masked by exp(cum_t - cum_s) dt_s) x, the
inter-chunk term exp(cum_t) C state^T, and the carried state
exp(cum_end) state + sum_s exp(cum_end - cum_s) dt_s x_s (outer) b_s —
the chunks of a sequence in order.

Bound on this card: operations (~130 float32 flops a byte at the
mamba2-130m width, P = 64, S = Q = 128).  A block owns one sequence and
up to 64 columns of P, walks its chunks in order with the state and the
chunk's b, c (transposed) and x in shared memory, and runs the chunk's
four products as register-tiled matrix products (see the source's
header).  It takes S a multiple of 4 (b and c rows are read as 16-byte
vectors) and P, S, Q up to 128.

On a CPU tensor the wrapper runs the plain PyTorch version
(``kernels.ops._ssd_chunked``); on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

#: Largest chunk length, state width and head width the kernel takes.
MAX_CHUNK = 128
MAX_STATE = 128
MAX_HEAD = 128

#: Launches of the CUDA kernel (the plain version does not count);
#: ``chip_smoke.py`` sets it to 0 and reads it to show that the served
#: prefill ran through the kernel.
LAUNCHES = 0

_LIB = None
_LIB_LOCK = threading.Lock()


def build() -> Tuple[Path, str]:
    """Compile ``csrc/ssd_scan.cu`` (see ``kernels/nvcc.py``)."""
    return nvcc.build(SOURCE, NVCC_FLAGS)


def _library():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()[0]))
            fn = lib.ssd_scan_f32
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 +
                           [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def ssd_scan_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan over flattened (batch*head) sequences.

    x: (BH, L, P); dt: (BH, L); a: (BH,); b, c: (BH, L, S), already
    head-expanded, all float32 and contiguous.  L must be a multiple of
    ``chunk`` (the caller pads).  Returns (y: (BH, L, P),
    final_state: (BH, P, S)), both float32.
    """
    global LAUNCHES
    if x.dim() != 3 or b.dim() != 3:
        raise ValueError(f"x and b must be 3-D, got {tuple(x.shape)} and "
                         f"{tuple(b.shape)}")
    bh, l, p = x.shape
    s = b.shape[-1]
    want = {"dt": (bh, l), "a": (bh,), "b": (bh, l, s), "c": (bh, l, s)}
    for name, t in (("dt", dt), ("a", a), ("b", b), ("c", c)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, x "
                             f"{tuple(x.shape)} needs {want[name]}")
    if not 1 <= chunk <= MAX_CHUNK or l < chunk or l % chunk:
        raise ValueError(f"L={l} must be a positive multiple of the chunk "
                         f"{chunk}, and 1 <= chunk <= {MAX_CHUNK}")
    if x.device.type == "cpu":
        from repro_torch.kernels import ops
        return ops._ssd_chunked(x, dt, a, b, c, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {x.device}")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (1 <= p <= MAX_HEAD and 1 <= s <= MAX_STATE and s % 4 == 0):
        raise ValueError(f"the kernel takes 1 <= P <= {MAX_HEAD} and "
                         f"S <= {MAX_STATE} a multiple of 4, got P={p}, "
                         f"S={s}")
    if b.data_ptr() % 16 or c.data_ptr() % 16:
        raise ValueError("b and c must start on a 16-byte boundary")
    if max(bh, l) >= 2 ** 31 - 1:
        raise ValueError("BH or L too large for the kernel's 32-bit launch "
                         "arguments")

    y = torch.empty((bh, l, p), dtype=torch.float32, device=x.device)
    state = torch.empty((bh, p, s), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().ssd_scan_f32(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), state.data_ptr(), bh, l, p, s, chunk,
        stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_f32 launch failed: CUDA error {err} "
                           f"(BH={bh}, L={l}, P={p}, S={s}, Q={chunk})")
    LAUNCHES += 1
    return y, state
