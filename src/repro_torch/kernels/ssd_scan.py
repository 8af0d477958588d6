"""Hopper kernel: Mamba2 SSD (state-space duality) chunked scan.

Replaces the TPU kernel ``repro.kernels.ssd_scan.ssd_scan_chunked``
(Pallas body ``_ssd_kernel``) with CUDA C++ kernels for sm_90a,
``csrc/ssd_scan.cu``, built with ``nvcc`` at first use into
``kernels/_build/`` (``kernels/nvcc.py``) and bound through a plain C entry
point loaded with ``ctypes``.

What it computes, per sequence of the flattened (batch * head) axis and
chunk of Q steps, with cum = cumsum(dt * a) over the chunk: the causal
intra-chunk term (C B^T masked by exp(cum_t - cum_s) dt_s) x, the
inter-chunk term exp(cum_t) C state^T, and the carried state
exp(cum_end) state + sum_s exp(cum_end - cum_s) dt_s x_s (outer) b_s —
the chunks of a sequence in order.

Bound on this card: operations (5.66 GFLOP at mamba2-130m's served shape,
BH 96, L 1024, P 64, S = Q = 128: 0.0844 ms at the 67 TFLOP/s float32
rate).  The work stays float32 on the CUDA cores, as the float32 contract
(rtol 1e-4 against the plain version) asks; no tensor cores.  One call
launches three chunk-parallel kernels (see the source's header): the
chunks' own states and decays, grid (sequence, chunk); a pass that
carries the state across each sequence's chunks, grid (sequence, tiles of
P x S); and each chunk's output from its scores and its incoming state,
grid (sequence, chunk).  Their own floor at the served shape is ~0.11 ms,
since the chunk states pass through device memory.  The workspace for
that (float32: the chunk states (BH, L/Q, P, S), cum (BH, L), the decays
(BH, L/Q); ``workspace_floats``) is allocated here with ``torch.empty``
on the input's device; the kernels allocate nothing, so a call can be
captured in a CUDA graph.  It takes S a multiple of 4 (b and c rows are
read as 16-byte vectors) and P, S, Q up to 128; x may start at any float
(its rows are read as 16-byte vectors only when P % 4 == 0 and x is
16-byte aligned).

On a CPU tensor the wrapper runs the plain PyTorch version
(``kernels.ops._ssd_chunked``); on a CUDA tensor it launches the kernels
or raises.
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

#: The CUDA kernels one call launches, in order (each name holds
#: ``ssd_scan``, so a profile counts them all).
KERNELS = ("ssd_scan_chunk_state_kernel", "ssd_scan_state_pass_kernel",
           "ssd_scan_chunk_out_kernel")

#: Calls that launched the CUDA kernels (the plain version does not
#: count); ``chip_smoke.py`` sets it to 0 and reads it to show that the
#: served prefill ran through the kernels.
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
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 +
                           [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            occ = lib.ssd_scan_occupancy
            occ.argtypes = [ctypes.c_int, ctypes.c_void_p]
            occ.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def workspace_floats(bh: int, l: int, p: int, s: int, chunk: int) -> int:
    """Floats of the kernels' workspace: the chunk states (then the
    incoming states) (BH, L/Q, P, S), cum (BH, L), the decays (BH, L/Q)."""
    nc = l // chunk
    return bh * nc * p * s + bh * l + bh * nc


def occupancy(p: int) -> dict:
    """Resident blocks an SM of each kernel at head width ``p`` on the
    current CUDA device (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    and the chunk-out block's dynamic shared memory in bytes."""
    out = (ctypes.c_int * 4)()
    err = _library().ssd_scan_occupancy(p, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"ssd_scan_occupancy failed: CUDA error {err}")
    return {**dict(zip(KERNELS, out[:3])), "chunk_out_smem_bytes": out[3]}


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
    ws = torch.empty(workspace_floats(bh, l, p, s, chunk),
                     dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().ssd_scan_f32(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), y.data_ptr(), state.data_ptr(), ws.data_ptr(), bh, l,
        p, s, chunk, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_f32 launch failed: CUDA error {err} "
                           f"(BH={bh}, L={l}, P={p}, S={s}, Q={chunk})")
    LAUNCHES += 1
    return y, state
