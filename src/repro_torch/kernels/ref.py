"""Plain PyTorch versions of the port's kernels.

``taom_gemm_reference`` is the plain version of
``kernels.taom_gemm.taom_gemm_quantized`` (counterpart of
``repro.kernels.ref.taom_gemm_reference``): it takes the same explicit
inputs as the kernel (pre-quantized operands, pre-sampled noise,
calibrated ADC scale), chunks K at the exact dpe_size, and shares the
kernel's ADC constants (``adc_round``).  The CPU tests run it against the
reference package; ``chip_smoke.py`` holds the CUDA kernel against it on
the card.

``photonic_gemm_reference`` is the plain version of the fused route
``kernels.taom_gemm.taom_gemm_fused`` (one s8 plane or two) and the
``impl="ref"`` path of
``ops.photonic_matmul`` (counterpart of the reference's
``repro.kernels.ops._taom_forward`` with ``impl="ref"``): quantize x per
tensor and w per column, ``taom_gemm_reference``, rescale, cast to x's
dtype.

``ssd_scan_reference`` is the naive per-token Mamba2 recurrence
(counterpart of ``repro.kernels.ref.ssd_scan_reference``): the oracle the
chunked plain version ``ops._ssd_chunked`` and the SSD kernel are checked
against.

``flash_attention_reference`` is the dense softmax-attention oracle of the
flash kernel (counterpart of ``repro.kernels.flash_attention.
flash_attention_reference``): the (S, S) scores made whole.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.photonic_gemm import CHUNK_ADC_BACKENDS, detection_sigma
from repro_torch.core.taom import quantize
from repro_torch.core.types import PhotonicConfig
from repro_torch.kernels.taom_gemm import adc_round, chunk_fs


def _sum_chunks(t: torch.Tensor) -> torch.Tensor:
    """Sum over the leading chunk axis in chunk order (0 + t0 + t1 + ...),
    the order the kernel accumulates in."""
    acc = t[0]
    for c in range(1, t.shape[0]):
        acc = acc + t[c]
    return acc


def taom_gemm_reference(xq: torch.Tensor, wq: torch.Tensor,
                        noise: Optional[torch.Tensor], cfg: PhotonicConfig,
                        adc_fs: float) -> torch.Tensor:
    """Plain version of kernels.taom_gemm.taom_gemm_quantized (noise None:
    noise off, the noise term left out)."""
    m, k = xq.shape
    _, d = wq.shape
    n = cfg.dpe_size
    n_chunks = max(1, -(-k // n))
    kp = n_chunks * n - k
    x = F.pad(xq.to(torch.float32), (0, kp))
    w = F.pad(wq.to(torch.float32), (0, 0, 0, kp))
    xc = x.reshape(m, n_chunks, n).transpose(0, 1)            # (C, M, N)
    wc = w.reshape(n_chunks, n, d)                            # (C, N, D)
    psums = torch.bmm(xc, wc)                                 # (C, M, D)
    sigma = detection_sigma(cfg)
    if cfg.backend in CHUNK_ADC_BACKENDS:
        if noise is not None:
            if tuple(noise.shape) != (n_chunks, m, d):
                raise ValueError(f"noise {tuple(noise.shape)} != "
                                 f"{(n_chunks, m, d)}")
            psums = psums + sigma * noise
        return _sum_chunks(adc_round(psums, cfg.adc_bits, chunk_fs(cfg)))
    acc = _sum_chunks(psums)
    if noise is not None:
        if tuple(noise.shape) != (m, d):
            raise ValueError(f"noise {tuple(noise.shape)} != {(m, d)}")
        acc = acc + sigma * math.sqrt(float(n_chunks)) * noise
    return adc_round(acc, cfg.adc_bits, float(adc_fs))


def photonic_gemm_reference(x2d: torch.Tensor, w: torch.Tensor,
                            noise: Optional[torch.Tensor],
                            cfg: PhotonicConfig,
                            adc_fs: float) -> torch.Tensor:
    """Plain version of kernels.taom_gemm.taom_gemm_fused: quantize ->
    taom_gemm_reference -> rescale, (M, D) in x2d's dtype."""
    f32 = torch.float32
    xq, sx = quantize(x2d.to(f32), cfg.bits, axis=None)
    wq, sw = quantize(w.to(f32), cfg.bits, axis=0)
    acc = taom_gemm_reference(xq, wq, noise, cfg, adc_fs)
    return (acc * (sx * sw)).to(x2d.dtype)


def ssd_scan_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor,
                       initial_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Naive sequential Mamba2/SSD recurrence — oracle for kernels.ssd_scan.

    Shapes (single batch element):
      x:  (L, H, P)   input per head (P = head dim)
      dt: (L, H)      softplus-activated step sizes (>0)
      a:  (H,)        negative state decay rate (A = -exp(a_log) outside)
      b:  (L, G, S)   input->state projection (G state groups, S state dim)
      c:  (L, G, S)   state->output projection
    Heads are grouped: head h uses group g = h // (H // G).
    Returns (y: (L, H, P), final_state: (H, P, S)).
    """
    l, h, p = x.shape
    g, s = b.shape[1], b.shape[2]
    heads_per_group = h // g
    state = (torch.zeros((h, p, s), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.to(torch.float32))
    ys = []
    for t in range(l):
        dt_t = dt[t]                                       # (H,)
        decay = torch.exp(dt_t * a)                        # (H,)  a < 0
        b_h = b[t].repeat_interleave(heads_per_group, 0)   # (H, S)
        c_h = c[t].repeat_interleave(heads_per_group, 0)   # (H, S)
        upd = (dt_t[:, None] * x[t])[:, :, None] * b_h[:, None, :]
        state = decay[:, None, None] * state + upd
        ys.append(torch.einsum("hps,hs->hp", state, c_h))
    return torch.stack(ys).to(x.dtype), state


NEG_INF = -1.0e30     # the flash kernel's fill for masked scores


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0) -> torch.Tensor:
    """Dense oracle: (BH, S, D) softmax attention with the flash kernel's
    mask — float32 scores times D**-0.5, masked scores set to -1e30,
    softmax, then P V, cast to q's dtype."""
    _, s, d = q.shape
    f32 = torch.float32
    scores = torch.einsum("bqd,bkd->bqk", q.to(f32), k.to(f32)) * (d ** -0.5)
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(s, device=q.device)[None, :]
    valid = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kj <= qi
    if window:
        valid &= kj > qi - window
    scores = torch.where(valid[None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v.to(f32)).to(q.dtype)
