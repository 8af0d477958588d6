"""The card's published peaks and the least time of the network's GEMMs.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
1,979 TOP/s int8 on the tensor cores and 3.35 TB/s of HBM.  The TAOM
route runs 4-bit operands as s8, so int8 is its rate.

A GEMM's bound is counted from the layer's own work, (M, K, D, count) as
``models/lowering.graph_gemms`` gives it for one image: 2 M K D count
operations, and x (M, K), w (K, D) and the output (M, D) once each as
float32, count times.  A depthwise layer is C instances of (M, k*k, 1): its
k*k*C weights and k*k*C*M multiply-adds, not the block-diagonal GEMM's
(k*k*C) x C operand that the port executes, so a later depthwise kernel
reads as the same work done faster.
"""
from __future__ import annotations

from typing import Iterable, Tuple

INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
ELT_BYTES = 4

Gemm = Tuple[int, int, int, int]      # (M per image, K, D, count)


def gemm_ops(m: int, k: int, d: int, count: int) -> float:
    return 2.0 * m * k * d * count


def gemm_bytes(m: int, k: int, d: int, count: int) -> float:
    return float(ELT_BYTES * (m * k + k * d + m * d) * count)


def gemm_bound_s(m: int, k: int, d: int, count: int) -> float:
    """Least time of one GEMM: operations at the int8 rate or bytes at
    HBM's, whichever is longer."""
    return max(gemm_ops(m, k, d, count) / INT8_OPS_PER_S,
               gemm_bytes(m, k, d, count) / HBM_BYTES_PER_S)


def forward_bound_s(gemms: Iterable[Gemm], images: int) -> float:
    """Least time of the network's GEMMs over ``images`` images in one
    forward (the rows of every layer but the classifier scale with the
    images; the classifier has one row an image)."""
    return sum(gemm_bound_s(m * images, k, d, count)
               for m, k, d, count in gemms)


def useful_macs(gemms: Iterable[Gemm]) -> int:
    """Multiply-adds of one image."""
    return sum(m * k * d * count for m, k, d, count in gemms)
