"""Entry points around the port's kernels (counterpart of
``repro.kernels.ops``): ``photonic_matmul``, ``ssd_scan`` and
``flash_attention``.

``photonic_matmul``: quantize -> TAOM GEMM -> rescale, with an STE
backward.

This is what the model zoo calls.  It folds leading dimensions into the
GEMM's M axis, quantizes both operands, runs the chunked TAOM GEMM and
rescales.  On CUDA tensors (``impl="kernel"``) operands of at most 7 bits
take the fused int8 route, which does all three in its two kernels
(``kernels/taom_gemm.taom_gemm_fused``); 8-bit operands are quantized and
rescaled here around the float32 body (``taom_gemm_quantized``).  CPU
tensors, or ``impl="ref"``, take the plain version
(``kernels/ref.photonic_gemm_reference``).
The backward is the straight-through estimator of the reference's
``custom_vjp``: gradients of an exact matmul, ``g @ w.T`` and ``x.T @ g``.

``ssd_scan`` is the Mamba2 scan: the Hopper kernel
(``kernels/ssd_scan.py``) for CUDA tensors, the plain chunked version
``_ssd_chunked`` (the same decomposition as the reference's
``_ssd_chunked_jax``, in float32) for CPU tensors or when asked.  ``ssd_decode_step`` is the
one-token recurrence of serving (the reference has no kernel for it).

``flash_attention`` is forward softmax attention over head-folded
(BH, S, D) tensors: the Hopper kernel (``kernels/flash_attention.py``) for
CUDA tensors, the plain version ``_flash_blocked`` (the online softmax of
the reference's Pallas kernel, ``repro.kernels.flash_attention``) for CPU
tensors or when asked.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.photonic_gemm import (CHUNK_ADC_BACKENDS, noise_shape,
                                            sample_noise)
from repro_torch.core.taom import quantize
from repro_torch.core.types import Backend, PhotonicConfig
from repro_torch.kernels import flash_attention as flash_kernel_mod
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels import ssd_scan as ssd_kernel_mod
from repro_torch.kernels import taom_gemm as taom_kernel_mod

IMPLS = ("auto", "kernel", "ref")


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


_INT8_INPUTS = (torch.float32, torch.bfloat16)


def _taom_forward(x2d: torch.Tensor, w: torch.Tensor,
                  noise: Optional[torch.Tensor],
                  cfg: PhotonicConfig, adc_fs: float, impl: str,
                  blocks: tuple) -> torch.Tensor:
    if impl == "ref":
        return ref_mod.photonic_gemm_reference(x2d, w, noise, cfg, adc_fs)
    if taom_kernel_mod.int8_route(cfg):
        # The fused int8 route takes float32 or bfloat16 operands; any
        # other type is widened as the reference's quantize widens it.
        xk = x2d if x2d.dtype in _INT8_INPUTS else x2d.to(torch.float32)
        wk = w if w.dtype in _INT8_INPUTS else w.to(torch.float32)
        out = taom_kernel_mod.taom_gemm_fused(
            xk.contiguous(), wk.contiguous(), noise, cfg, adc_fs,
            block_m=blocks[0], block_d=blocks[1])
        return out.to(x2d.dtype)
    f32 = torch.float32
    xq, sx = quantize(x2d.to(f32), cfg.bits, axis=None)
    wq, sw = quantize(w.to(f32), cfg.bits, axis=0)
    acc = taom_kernel_mod.taom_gemm_quantized(
        xq.contiguous(), wq.contiguous(), noise, cfg, adc_fs,
        block_m=blocks[0], block_d=blocks[1])
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
                    block_m: int = 128, block_d: int = 128,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Photonic-numerics matmul: (..., K) @ (K, D) -> (..., D).

    impl: 'auto' (the kernel for CUDA tensors, the plain version for CPU
    tensors) | 'kernel' | 'ref'.  adc_fs: calibrated PGA full scale;
    default = analytic calibration.  block_m/block_d: a LayerPlan's tile
    (mapped onto the kernel's own tile; numerics are tile-invariant).

    Noise contract: ``cfg.noise_enabled=True`` requires a ``generator``
    (on x's device) or pre-drawn ``noise``; without either this raises —
    disable noise explicitly (``noise_enabled=False``) to run
    deterministically.  ``noise`` is the standard-normal draw that
    ``sample_noise(generator, (M, K), w.shape, cfg)`` would make, M the
    product of x's leading dimensions: the executor draws every layer's
    noise before its forward, so that a forward captured in a CUDA graph
    reads it from static buffers.  The EXACT backend bypasses the
    photonic pipeline, so ``noise_enabled`` does not apply.
    """
    if cfg.backend == Backend.EXACT:
        return x @ w
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if cfg.noise_enabled and generator is None and noise is None:
        raise ValueError(
            "photonic_matmul: cfg.noise_enabled=True but generator=None — "
            "detection noise needs a torch.Generator on x's device (or "
            "pre-drawn noise); or set noise_enabled=False to run "
            "deterministically")
    if impl == "auto":
        impl = "kernel" if x.is_cuda else "ref"
    if adc_fs is None:
        adc_fs = taom_kernel_mod.calibrated_adc_fs(x.shape[-1], cfg)
    batch_shape = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if not cfg.noise_enabled:
        noise = None                # noise off: the GEMM skips the term
    elif noise is not None:
        want = noise_shape(tuple(x2d.shape), tuple(w.shape), cfg)
        if tuple(noise.shape) != want or noise.device != x.device:
            raise ValueError(f"noise is {tuple(noise.shape)} on "
                             f"{noise.device}, the GEMM needs {want} on "
                             f"{x.device}")
    else:
        if not _same_device(generator.device, x.device):
            raise ValueError(f"generator is on {generator.device} but x is "
                             f"on {x.device}")
        noise = sample_noise(generator, tuple(x2d.shape), tuple(w.shape), cfg)
    if noise is not None:
        if cfg.backend in CHUNK_ADC_BACKENDS:
            noise = noise.movedim(-2, 0).contiguous()   # (M,C,D) -> (C,M,D)
    out = _TaomSTE.apply(x2d, w, noise, cfg, float(adc_fs), impl,
                         (int(block_m), int(block_d)))
    return out.reshape(*batch_shape, w.shape[-1])


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------
def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the SSD kernel: the chunked decomposition of the
    reference's ``_ssd_chunked_jax`` in float32 (intra-chunk causal scores,
    per-chunk states, a loop carrying the state across chunks, inter-chunk
    term).  Shapes as ``kernels.ssd_scan.ssd_scan_chunked``; L must be a
    multiple of ``chunk``."""
    bh, l, p = x.shape
    s = b.shape[-1]
    n_chunks = l // chunk
    f32 = torch.float32
    xc = x.reshape(bh, n_chunks, chunk, p).to(f32)
    dtc = dt.reshape(bh, n_chunks, chunk).to(f32)
    bc = b.reshape(bh, n_chunks, chunk, s).to(f32)
    cc = c.reshape(bh, n_chunks, chunk, s).to(f32)
    a = a.to(f32)

    da = dtc * a[:, None, None]                       # (BH, C, Q)
    cum = torch.cumsum(da, dim=-1)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    # seg > 0 above the diagonal, where exp() may overflow: a select, not
    # a multiply by the mask, keeps the inf out of the result.
    seg = cum[..., :, None] - cum[..., None, :]       # (BH, C, Q, Q)
    lmat = torch.where(causal, torch.exp(seg) * dtc[..., None, :], 0.0)
    scores = torch.einsum("zkqs,zkts->zkqt", cc, bc) * lmat
    y_intra = torch.einsum("zkqt,zktp->zkqp", scores, xc)

    # Per-chunk state contribution and decay.
    wgt = torch.exp(cum[..., -1:] - cum) * dtc        # (BH, C, Q)
    chunk_states = torch.einsum("zkqp,zkqs->zkps", wgt[..., None] * xc, bc)
    chunk_decay = torch.exp(cum[..., -1])             # (BH, C)

    state = torch.zeros((bh, p, s), dtype=f32, device=x.device)
    prev_states = []                                  # state *before* k
    for k in range(n_chunks):
        prev_states.append(state)
        state = state * chunk_decay[:, k, None, None] + chunk_states[:, k]
    prev = torch.stack(prev_states, dim=1)            # (BH, C, P, S)

    y_inter = torch.einsum("zkqs,zkps->zkqp", cc, prev) * \
        torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bh, l, p).to(x.dtype)
    return y, state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *, chunk: int = 128,
             impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan over flattened (batch*head) sequences.

    x: (BH, L, P); dt: (BH, L); a: (BH,); b, c: (BH, L, S).  Pads L with
    zeros up to a chunk multiple (dt = 0 there: decay 1 and no update, so
    the final state is unaffected) and slices y back.  impl: 'auto' (the
    kernel for CUDA tensors, the plain version for CPU tensors) | 'kernel'
    | 'ref', as in ``photonic_matmul``.
    Returns (y: (BH, L, P), final_state: (BH, P, S) float32).
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    l = x.shape[1]
    lpad = (-l) % chunk
    if lpad:
        x = F.pad(x, (0, 0, 0, lpad))
        dt = F.pad(dt, (0, lpad))
        b = F.pad(b, (0, 0, 0, lpad))
        c = F.pad(c, (0, 0, 0, lpad))
    if impl == "auto":
        impl = "kernel" if x.is_cuda else "ref"
    if impl == "kernel":
        y, state = ssd_kernel_mod.ssd_scan_chunked(
            x.contiguous(), dt.contiguous(), a.contiguous(), b.contiguous(),
            c.contiguous(), chunk=chunk)
    else:
        y, state = _ssd_chunked(x, dt, a, b, c, chunk)
    return y[:, :l], state


def ssd_decode_step(state: torch.Tensor, x_t: torch.Tensor,
                    dt_t: torch.Tensor, a: torch.Tensor, b_t: torch.Tensor,
                    c_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD recurrence for serving.

    state: (BH, P, S); x_t: (BH, P); dt_t: (BH,); a: (BH,);
    b_t, c_t: (BH, S).  Returns (y_t: (BH, P), new_state).
    """
    decay = torch.exp(dt_t * a)                        # (BH,)
    upd = (dt_t[:, None] * x_t)[:, :, None] * b_t[:, None, :]
    new_state = decay[:, None, None] * state + upd
    y = torch.einsum("zps,zs->zp", new_state, c_t)
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------
def _flash_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, window: int = 0, block_q: int = 128,
                   block_k: int = 128) -> torch.Tensor:
    """Plain version of the flash kernel, with the TPU kernel's numerics:
    an online softmax over key blocks with float32 running max ``m``, sum
    ``l`` and accumulator ``acc``; masked scores *set* to -1e30 (padded
    keys ``kj >= S``, and ``kj <= qi`` / ``kj > qi - window`` from global
    indices); ``corr = exp(m_prev - m_new)``; output ``acc / max(l,
    1e-30)`` in q's dtype.  S is padded to the block multiples as
    ``flash_attention_fwd`` pads it and sliced back.  Every query row runs
    the same sequence of key blocks as in the TPU kernel, so the query
    blocks are made in one pass."""
    bh, s, d = q.shape
    scale = d ** -0.5
    bq = min(block_q, max(8, s))
    bk = min(block_k, max(8, s))
    sp = max(-(-s // bq) * bq, -(-s // bk) * bk)
    f32 = torch.float32
    qf, kf, vf = (F.pad(t.to(f32), (0, 0, 0, sp - s)) for t in (q, k, v))
    qi = torch.arange(sp, device=q.device)[:, None]
    m = torch.full((bh, sp, 1), ref_mod.NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((bh, sp, 1), dtype=f32, device=q.device)
    acc = torch.zeros((bh, sp, d), dtype=f32, device=q.device)
    for k0 in range(0, sp, bk):
        sc = torch.matmul(qf, kf[:, k0:k0 + bk].transpose(1, 2)) * scale
        kj = k0 + torch.arange(bk, device=q.device)[None, :]
        valid = kj < s                  # padded keys are never attended
        if causal:
            valid = valid & (kj <= qi)
        if window:
            valid = valid & (kj > qi - window)
        sc = torch.where(valid, sc, ref_mod.NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vf[:, k0:k0 + bk])
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out[:, :s].to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    impl: str = "auto") -> torch.Tensor:
    """Softmax attention over (BH, S, D) q, k, v (heads folded into the
    batch axis, K and V already expanded per head) -> (BH, S, D) in q's
    dtype.  impl: 'auto' (the kernel for CUDA tensors, the plain version
    for CPU tensors) | 'kernel' | 'ref', as in ``photonic_matmul``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "ref"
    if impl == "kernel":
        return flash_kernel_mod.flash_attention_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window)
    return _flash_blocked(q, k, v, causal, window)
