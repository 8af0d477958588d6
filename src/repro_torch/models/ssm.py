"""Mamba2 (SSD) block — arXiv:2405.21060 (counterpart of
``repro.models.ssm``).

Block: in_proj -> [z | xBC | dt]; causal depthwise conv over xBC; SSD scan
(chunked: the Hopper kernel ``kernels/ssd_scan.py`` on the card, the
plain chunked version on the CPU or with ``impl="ref"``); gated
RMSNorm; out_proj.  The dtype flow is the reference's: the scan runs in
float32, y is cast back to the model dtype before the gated norm, and the
conv history is kept in float32.

Decode state: {"conv": (B, W-1, C_xbc), "ssm": (B, H, P, S)} — O(1) per
token.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) with no threshold, as ``jax.nn.softplus``
    (``torch.nn.functional.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def dims(d_model: int, s: SSMConfig):
    d_inner = s.expand * d_model
    n_heads = d_inner // s.head_dim
    d_xbc = d_inner + 2 * s.n_groups * s.state_dim
    return d_inner, n_heads, d_xbc


def make_mamba(maker: L.ParamMaker, name: str, d_model: int,
               s: SSMConfig) -> dict:
    d_inner, n_heads, d_xbc = dims(d_model, s)
    d_in_proj = 2 * d_inner + 2 * s.n_groups * s.state_dim + n_heads
    return {
        "in_proj": L.make_dense(maker, f"{name}.in_proj", d_model, d_in_proj,
                                (L.EMBED, L.SSM_INNER)),
        "conv_w": maker.param(f"{name}.conv_w", (s.conv_width, d_xbc),
                              (None, L.SSM_INNER), scale=s.conv_width ** -0.5),
        "conv_b": maker.param(f"{name}.conv_b", (d_xbc,), (L.SSM_INNER,),
                              init="zeros"),
        "dt_bias": maker.param(f"{name}.dt_bias", (n_heads,), (None,),
                               init="zeros"),
        "a_log": maker.param(f"{name}.a_log", (n_heads,), (None,),
                             init="zeros"),
        "d_skip": maker.param(f"{name}.d_skip", (n_heads,), (None,),
                              init="ones"),
        "norm": L.make_rms_norm(maker, f"{name}.norm", d_inner),
        "out_proj": L.make_dense(maker, f"{name}.out_proj", d_inner, d_model,
                                 (L.SSM_INNER, L.EMBED)),
    }


def init_state(d_model: int, s: SSMConfig, batch: int,
               dtype=torch.float32, device=None) -> dict:
    d_inner, n_heads, d_xbc = dims(d_model, s)
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, d_xbc), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, n_heads, s.head_dim, s.state_dim),
                           dtype=dtype, device=device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, width W.  history: (B, W-1, C) carried state.
    Computed in xbc's dtype, one rounded op at a time, as the reference."""
    bsz, l, c = xbc.shape
    width = w.shape[0]
    if history is None:
        history = torch.zeros((bsz, width - 1, c), dtype=xbc.dtype,
                              device=xbc.device)
    xp = torch.cat([history.to(xbc.dtype), xbc], dim=1)
    out = xp[:, 0:l, :] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + l, :] * w[i]
    return L.silu(out + b)


def _split(params, x, d_model, s: SSMConfig, ctx, name):
    d_inner, n_heads, d_xbc = dims(d_model, s)
    proj = L.dense(params["in_proj"], x, ctx, f"{name}.in_proj")
    z, xbc, dt = torch.split(proj, [d_inner, d_xbc, proj.shape[-1] - d_inner
                                    - d_xbc], dim=-1)
    return z, xbc, dt, d_inner, n_heads


def _heads(t: torch.Tensor, bsz: int, l: int, n: int, hpg: int
           ) -> torch.Tensor:
    """(B, L, G*n) -> (B*H, L, n): each group repeated for its heads."""
    g = t.shape[-1] // n
    t = t.reshape(bsz, l, g, n).repeat_interleave(hpg, dim=2)
    return t.transpose(1, 2).reshape(bsz * g * hpg, l, n)


def mamba_block(params: dict, x: torch.Tensor, d_model: int, s: SSMConfig,
                ctx: L.PhotonicCtx = L.EXACT_CTX, name: str = "mamba",
                state: Optional[dict] = None, return_state: bool = False,
                impl: str = "auto") -> Tuple[torch.Tensor, Optional[dict]]:
    """Full-sequence Mamba2 block.  x: (B, L, D).  impl: the SSD scan's
    ('auto' | 'kernel' | 'ref', see ``kernels.ops.ssd_scan``)."""
    f32 = torch.float32
    bsz, l, _ = x.shape
    z, xbc_raw, dt, d_inner, n_heads = _split(params, x, d_model, s, ctx,
                                              name)
    conv_hist = None if state is None else state["conv"]
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"], conv_hist)
    gs = s.n_groups * s.state_dim
    xs, b, c = torch.split(xbc, [d_inner, gs, gs], dim=-1)
    p = s.head_dim
    hpg = n_heads // s.n_groups

    dt = softplus(dt.to(f32) + params["dt_bias"].to(f32))       # (B,L,H)
    a = -torch.exp(params["a_log"].to(f32))                      # (H,)

    # flatten to (B*H, L, ...) for the kernel
    xh = xs.reshape(bsz, l, n_heads, p).transpose(1, 2) \
        .reshape(bsz * n_heads, l, p)
    dth = dt.transpose(1, 2).reshape(bsz * n_heads, l)
    ah = a.repeat(bsz)
    bh = _heads(b, bsz, l, s.state_dim, hpg)
    ch = _heads(c, bsz, l, s.state_dim, hpg)

    y, final = kops.ssd_scan(xh.to(f32), dth, ah, bh.to(f32), ch.to(f32),
                             chunk=s.chunk, impl=impl)
    y = y.reshape(bsz, n_heads, l, p).transpose(1, 2)
    y = y + xh.reshape(bsz, n_heads, l, p).transpose(1, 2).to(f32) * \
        params["d_skip"].to(f32)[None, None, :, None]
    y = y.reshape(bsz, l, d_inner).to(x.dtype)

    y = L.rms_norm(params["norm"], y * L.silu(z))
    out = L.dense(params["out_proj"], y, ctx, f"{name}.out_proj")

    new_state = None
    if return_state:
        hist = (torch.zeros((bsz, s.conv_width - 1, xbc_raw.shape[-1]),
                            dtype=xbc_raw.dtype, device=xbc_raw.device)
                if state is None else state["conv"].to(xbc_raw.dtype))
        # conv history = last W-1 *raw* conv inputs
        new_state = {
            "conv": torch.cat([hist, xbc_raw], dim=1)
            [:, -(s.conv_width - 1):, :].to(f32),
            "ssm": final.reshape(bsz, n_heads, p, s.state_dim),
        }
    return out, new_state


def mamba_decode_step(params: dict, x: torch.Tensor, d_model: int,
                      s: SSMConfig, state: dict,
                      ctx: L.PhotonicCtx = L.EXACT_CTX,
                      name: str = "mamba") -> Tuple[torch.Tensor, dict]:
    """Single-token decode.  x: (B, 1, D); state from init_state/prefill."""
    f32 = torch.float32
    bsz = x.shape[0]
    z, xbc, dt, d_inner, n_heads = _split(params, x, d_model, s, ctx, name)
    # rolling conv state
    hist = state["conv"].to(xbc.dtype)                     # (B, W-1, C)
    window = torch.cat([hist, xbc], dim=1)                 # (B, W, C)
    # The reference's einsum: exact products summed in float32, rounded
    # once to the model dtype.
    conv_out = (window.to(f32) * params["conv_w"].to(f32)).sum(1) \
        .to(xbc.dtype) + params["conv_b"]
    xbc_t = L.silu(conv_out)                               # (B, C)
    new_conv = window[:, 1:, :].to(f32)

    gs = s.n_groups * s.state_dim
    xs, b, c = torch.split(xbc_t, [d_inner, gs, gs], dim=-1)
    p = s.head_dim
    hpg = n_heads // s.n_groups
    dt_t = softplus(dt[:, 0].to(f32) + params["dt_bias"].to(f32))  # (B,H)
    a = -torch.exp(params["a_log"].to(f32))

    xh = xs.reshape(bsz * n_heads, p).to(f32)
    bh = b.reshape(bsz, s.n_groups, s.state_dim) \
        .repeat_interleave(hpg, dim=1).reshape(bsz * n_heads, s.state_dim) \
        .to(f32)
    ch = c.reshape(bsz, s.n_groups, s.state_dim) \
        .repeat_interleave(hpg, dim=1).reshape(bsz * n_heads, s.state_dim) \
        .to(f32)
    st = state["ssm"].reshape(bsz * n_heads, p, s.state_dim)
    y, new_st = kops.ssd_decode_step(st, xh, dt_t.reshape(-1), a.repeat(bsz),
                                     bh, ch)
    y = y + xh * params["d_skip"].to(f32).repeat(bsz)[:, None]
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = L.rms_norm(params["norm"], y * L.silu(z))
    out = L.dense(params["out_proj"], y, ctx, f"{name}.out_proj")
    return out, {"conv": new_conv,
                 "ssm": new_st.reshape(bsz, n_heads, p, s.state_dim)}
