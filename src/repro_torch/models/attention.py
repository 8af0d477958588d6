"""Attention: GQA with bias / sliding window / local-global (counterpart of
``repro.models.attention``).

Covers the dense family's attention: qwen2 (GQA with QKV bias, tiny
kv_heads, ``head_pad``), h2o-danube3 (sliding window), gemma3 (5:1
local:global), plus plain GQA and cross-attention (``kv_source``).  Not
ported yet: MLA (deepseek, ROADMAP A7c) raises ``NotImplementedError``; the
reference's ``flash_decode_gqa`` and ``decode_axes`` (a ``shard_map``
flash-decode over a device mesh, ROADMAP A9) are left out — the port runs
on one device, where the reference itself takes the grouped einsum.

KV caches are explicit dicts:
  {"k": (B, S, KVH, HD), "v": ..., "pos": (B, S) int32}
Sliding-window layers allocate min(window, S) slots and write at
``index % slots`` (rolling); ``pos`` (-1 = empty) makes masking exact even
mid-warmup.  The prefill returns new cache tensors, as the reference's
does.  A decode step writes its slot in place (``index_copy_``, the slot
computed on the device) and returns the cache it was given, so that a
step captures in a CUDA graph over static caches and no step copies the
whole cache (the reference returns new tensors).  Its index is a Python
int or a 0-d integer tensor on the cache's device.

``attention(attn_impl=...)`` picks how self-attention over a whole prompt
is computed: 'dense' is the reference's default XLA path
(``_gqa_scores_softmax_out``); 'kernel' / 'ref' run the flash kernel /
its plain version (``kernels.ops.flash_attention``) on head-folded
(B*H, S, HD) tensors with K and V expanded per padded head, exactly as the
reference's ``attn_impl="pallas"`` branch does; 'auto' is 'kernel' on CUDA
tensors and 'ref' on CPU tensors.  The flash route applies where the
reference's Pallas branch applies (S > 1, no ``kv_source``, no cache) and
also to the prefill into an empty cache, which computes the same function:
the prompt's own K and V under ``_mask_bias(positions, positions, window,
causal)``.  Like the Pallas branch it masks by index, so the prompt's
positions must run 0..S-1 (as every prefill's do).  Decode (S == 1)
always takes the grouped einsum, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

NEG_INF = -2.0e38

#: attention()'s attn_impl values ('dense' plus the flash kernel's impls).
ATTN_IMPLS = ("auto", "kernel", "ref", "dense")


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 1e6
    qkv_bias: bool = False
    window: int = 0                  # 0 = full attention
    mla: Optional[MLAConfig] = None
    causal: bool = True              # False for encoder self-attention
    use_rope: bool = True
    head_pad: int = 1                # pad q heads to a multiple of this

    @property
    def padded_heads(self) -> int:
        return -(-self.num_heads // self.head_pad) * self.head_pad


def _no_mla(spec: AttnSpec) -> None:
    if spec.mla is not None:
        raise NotImplementedError("MLA attention (deepseek) is not ported "
                                  "yet (ROADMAP A7c)")


def make_attention(maker: L.ParamMaker, name: str, spec: AttnSpec) -> dict:
    _no_mla(spec)
    d, kvh, hd = spec.d_model, spec.num_kv_heads, spec.head_dim
    hp = spec.padded_heads   # weight-level head padding, as the reference
    return {
        "wq": L.make_dense(maker, f"{name}.wq", d, hp * hd,
                           (L.EMBED, L.HEADS), bias=spec.qkv_bias),
        "wk": L.make_dense(maker, f"{name}.wk", d, kvh * hd,
                           (L.EMBED, L.KV_HEADS), bias=spec.qkv_bias),
        "wv": L.make_dense(maker, f"{name}.wv", d, kvh * hd,
                           (L.EMBED, L.KV_HEADS), bias=spec.qkv_bias),
        "wo": L.make_dense(maker, f"{name}.wo", hp * hd, d,
                           (L.HEADS, L.EMBED)),
    }


def init_cache(spec: AttnSpec, batch: int, max_len: int,
               dtype=torch.bfloat16,
               device: torch.device = torch.device("cpu")) -> dict:
    _no_mla(spec)
    slots = min(spec.window, max_len) if spec.window else max_len
    shape = (batch, slots, spec.num_kv_heads, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, slots), -1, dtype=torch.int32,
                          device=device),
    }


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int,
               causal: bool) -> torch.Tensor:
    """(..., Sq, Sk) float32 additive mask from absolute positions (-1 =
    empty)."""
    kp = k_pos[..., None, :]
    qp = q_pos[..., :, None]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & (kp > qp - window)
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, NEG_INF)


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with float32 accumulation (products of bf16 values are exact
    in float32): the reference's preferred_element_type=float32 and its
    bf16 dots, which accumulate in float32 and round once."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def _gqa_scores_softmax_out(q, k, v, mask_bias, real_h: int):
    """q: (B,Sq,H_pad,hd), k/v: (B,Sk,KVH,hd) -> (B,Sq,H_pad,hd).

    The reference's default path.  K and V are gather-expanded per padded
    head and the dead heads (>= real_h) zeroed, so the semantics stay
    exactly ``real_h`` heads.  Decode (Sq == 1) keeps the grouped einsum
    over the real heads (no expansion across the cache).  Probabilities
    are rounded to v's dtype before P V, as in the reference.
    """
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = max(real_h // kvh, 1)
    if sq == 1:
        qr = q[:, :, :real_h, :] if h != real_h else q
        qg = qr.reshape(b, sq, kvh, g, hd)
        scores = _f32_einsum("bqkgd,bskd->bkgqs", qg, k)
        scores = scores * (hd ** -0.5) + mask_bias[:, None, None]
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = _f32_einsum("bkgqs,bskd->bqkgd", probs, v).to(v.dtype) \
            .reshape(b, sq, real_h, hd)
        if h != real_h:
            out = torch.nn.functional.pad(out, (0, 0, 0, h - real_h))
        return out

    kv_idx = torch.clamp(torch.arange(h, device=q.device) // g, 0, kvh - 1)
    k_exp = k[:, :, kv_idx]                        # (B,Sk,H_pad,hd)
    v_exp = v[:, :, kv_idx]
    scores = _f32_einsum("bqhd,bshd->bhqs", q, k_exp)
    scores = scores * (hd ** -0.5) + mask_bias[:, None]
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = _f32_einsum("bhqs,bshd->bqhd", probs, v_exp).to(v.dtype)
    if h != real_h:
        out = out * _live_heads(h, real_h, out)
    return out


def _live_heads(h: int, real_h: int, like: torch.Tensor) -> torch.Tensor:
    """(1, 1, H_pad, 1) mask of the real heads, in like's dtype."""
    return (torch.arange(h, device=like.device) < real_h)[
        None, None, :, None].to(like.dtype)


def _flash_self_attention(q, k, v, spec: AttnSpec, impl: str):
    """Self-attention over the prompt through the flash kernel (or its
    plain version): heads fold into the batch axis per the kernel's layout
    contract, K and V expanded per padded head first — the reference's
    ``attn_impl="pallas"`` branch."""
    b, s, h, hd = q.shape
    kvh = spec.num_kv_heads
    kv_idx = torch.clamp(torch.arange(h, device=q.device) //
                         max(spec.num_heads // kvh, 1), 0, kvh - 1)

    def fold(t):
        return t.transpose(1, 2).reshape(b * h, s, hd)

    o = kops.flash_attention(fold(q), fold(k[:, :, kv_idx]),
                             fold(v[:, :, kv_idx]), causal=spec.causal,
                             window=spec.window, impl=impl)
    out = o.reshape(b, h, s, hd).transpose(1, 2)
    if h != spec.num_heads:
        out = out * _live_heads(h, spec.num_heads, out)
    return out


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
              spec: AttnSpec, ctx: L.PhotonicCtx = L.EXACT_CTX,
              name: str = "attn",
              cache: Optional[dict] = None,
              cache_index=None,
              kv_source: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None,
              attn_impl: str = "auto",
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self- or cross-attention.

    x: (B, S, D); positions: (B, S) absolute positions of x.
    cache + cache_index=None  -> prefill: fill the cache's slots.
    cache + cache_index=i     -> decode: write at slot i % slots in place,
                                 S must be 1; i an int or a 0-d tensor.
    kv_source                 -> cross-attention (no cache, no rope).
    attn_impl                 -> 'auto' | 'kernel' | 'ref' | 'dense' (see
                                 the module docstring).
    Returns (out, updated_cache_or_None).
    """
    _no_mla(spec)
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    b, s, _ = x.shape
    h, kvh, hd = spec.padded_heads, spec.num_kv_heads, spec.head_dim
    q = L.dense(params["wq"], x, ctx, f"{name}.wq").reshape(b, s, h, hd)
    kv_in = kv_source if kv_source is not None else x
    sk = kv_in.shape[1]
    k = L.dense(params["wk"], kv_in, ctx, f"{name}.wk").reshape(b, sk, kvh, hd)
    v = L.dense(params["wv"], kv_in, ctx, f"{name}.wv").reshape(b, sk, kvh, hd)

    if spec.use_rope:
        q = L.apply_rope(q, positions, spec.rope_theta)
        if kv_source is None:
            k = L.apply_rope(k, positions, spec.rope_theta)

    new_cache = None
    if kv_source is not None:
        kpos = kv_positions if kv_positions is not None else \
            torch.arange(sk, dtype=torch.int32,
                         device=x.device)[None].expand(b, sk)
        mask = (positions, kpos, 0, False)
    elif cache is None:
        mask = (positions, positions, spec.window, spec.causal)
    else:
        slots = cache["k"].shape[1]
        if cache_index is None:                      # prefill into cache
            # Windowed caches keep only the last ``slots`` positions, placed
            # at slot = position % slots so later rolling decode writes stay
            # consistent with the prefill layout.
            kk, vv, pp = ((t[:, -slots:] if s > slots else t)
                          for t in (k, v, positions))
            idx = pp[0].long() % slots
            new_cache = {key: cache[key].clone() for key in ("k", "v", "pos")}
            new_cache["k"][:, idx] = kk.to(cache["k"].dtype)
            new_cache["v"][:, idx] = vv.to(cache["v"].dtype)
            new_cache["pos"][:, idx] = pp.to(torch.int32)
            # attend over the prompt's own K, V
            mask = (positions, positions, spec.window, spec.causal)
        else:                                        # single-token decode
            if s != 1:
                raise ValueError(f"decode takes one token, got S={s}")
            if not isinstance(cache_index, torch.Tensor):
                cache_index = torch.full((), int(cache_index),
                                         dtype=torch.int64, device=x.device)
            slot = cache_index.reshape(1).long() % slots
            cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
            cache["pos"].index_copy_(1, slot, positions.to(torch.int32))
            new_cache = cache
            k, v = cache["k"], cache["v"]
            mask = (positions, cache["pos"], spec.window, spec.causal)
    if attn_impl != "dense" and s > 1 and kv_source is None and \
            cache_index is None:
        out = _flash_self_attention(q, k, v, spec, attn_impl)
    else:
        out = _gqa_scores_softmax_out(q, k, v, _mask_bias(*mask),
                                      spec.num_heads)
    out = L.dense(params["wo"], out.reshape(b, s, h * hd), ctx,
                  f"{name}.wo")
    return out, new_cache
