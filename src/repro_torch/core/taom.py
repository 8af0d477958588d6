"""TAOM — hybrid Time-Amplitude analog Optical Multiplier (paper §3.2.2).

PyTorch counterpart of ``repro.core.taom``.  A TAOM is a single add-drop
microring modulator driven by a hybrid time-amplitude electrical signal:
the weight is a DAC amplitude level, the activation a DPC pulse width, an
RF mixer multiplies them, and the sign of the product selects the through
(+) or drop (-) port, i.e. the result is a balanced optical pulse pair.

``quantize`` keeps the reference's float formulation exactly — scale
``max(absmax, eps) * (1/qmax)`` as a reciprocal *multiply*, a true IEEE
division ``x / scale``, and round-half-to-even (``torch.round``) — so the
port's integer operands equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.types import TAOM_MAX_PULSE_WIDTH_NS, PhotonicConfig


def quantize(x: torch.Tensor, bits: int, axis=None, keepdims: bool = True,
             eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric B-bit quantization: returns integer-valued q and scale s.

    x ~= q * s with q in [-qmax, qmax] (qmax = 2^bits - 1).  ``axis=None``
    => per-tensor scale (a 0-dim tensor); an int/tuple axis gives
    per-channel scales (reduced over ``axis``).
    """
    qmax = (1 << bits) - 1
    if axis is None:
        absmax = x.abs().amax()
    else:
        absmax = x.abs().amax(dim=axis, keepdim=keepdims)
    scale = torch.clamp(absmax, min=eps) * (1.0 / qmax)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q, scale


def encode_time_amplitude(a_q: torch.Tensor, w_q: torch.Tensor, bits: int,
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map integer operands to physical drive signals.

    Returns (pulse_width_ns, amplitude_frac): the DPC pulse width carrying
    |a_q| and the DAC amplitude fraction carrying |w_q|.
    """
    qmax = (1 << bits) - 1
    pulse_width_ns = a_q.abs() / qmax * TAOM_MAX_PULSE_WIDTH_NS
    amplitude_frac = w_q.abs() / qmax
    return pulse_width_ns, amplitude_frac


def taom_multiply(a_q: torch.Tensor, w_q: torch.Tensor,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Balanced optical pulse areas (through, drop) for integer operands:
    through - drop == a_q * w_q, positive part on the through port."""
    prod = a_q * w_q
    return torch.clamp(prod, min=0.0), torch.clamp(-prod, min=0.0)


def taom_array_products(a_q: torch.Tensor, w_q: torch.Tensor,
                        cfg: PhotonicConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Products of a spectrally hitless TAOM array (no crosstalk term)."""
    del cfg
    return taom_multiply(a_q, w_q)
