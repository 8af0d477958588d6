"""Attention: GQA with bias / sliding window / local-global (counterpart of
``repro.models.attention``).

Covers every attention variant of the zoo: qwen2 (GQA with QKV bias, tiny
kv_heads, ``head_pad``), h2o-danube3 (sliding window), gemma3 (5:1
local:global), plain GQA (zamba2's shared block, llava's backbone),
whisper's non-causal encoder self-attention without RoPE and its
cross-attention (``kv_source``), and DeepSeek v2/v3's MLA: a low-rank
compressed KV cache, per-head K and V materialised over the prompt, and
a decode step that scores against the compressed cache with the
absorbed weights.  On a mesh (``dist``, a ``moe.DistCtx``) a GQA decode
step takes the reference's flash-decode (``flash_decode_gqa``, layout
``decode_axes``), a distributed softmax over the cache's slots split
over the model axis (with LOCAL, as in the reference, the grouped
einsum).

KV caches are explicit dicts:
  GQA:  {"k": (B, S, KVH, HD), "v": ..., "pos": (B, S) int32}
  MLA:  {"ckv": (B, S, R), "kr": (B, S, RD), "pos": (B, S) int32}
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
reference's Pallas branch applies (S > 1, no ``kv_source``, no cache:
whisper's encoder, causal or not) and also to the prefill into an empty
cache (every decoder's, whisper's included), which computes the same function:
the prompt's own K and V under ``_mask_bias(positions, positions, window,
causal)``.  Like the Pallas branch it masks by index, so the prompt's
positions must run 0..S-1 (as every prefill's do).  Decode (S == 1)
always takes the grouped einsum, as in the reference.  MLA's prompt takes
the same routes: 'dense' is the reference's, the flash route runs Q =
[q_nope, q_rope] against K = [k_nope, k_rope] (one head of D = nope +
rope, so the kernel's D^-0.5 is MLA's scale) with V zero-padded to D
(``_mla_flash``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import MLAConfig
from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as shd

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


def make_attention(maker: L.ParamMaker, name: str, spec: AttnSpec) -> dict:
    d, h, kvh, hd = (spec.d_model, spec.num_heads, spec.num_kv_heads,
                     spec.head_dim)
    if spec.mla is not None:
        m = spec.mla
        p = {
            "wq": L.make_dense(maker, f"{name}.wq", d,
                               h * (m.qk_nope_dim + m.qk_rope_dim),
                               (L.EMBED, L.HEADS)),
            "wkv_a": L.make_dense(maker, f"{name}.wkv_a", d,
                                  m.kv_lora_rank + m.qk_rope_dim,
                                  (L.EMBED, None)),
            "wk_b": L.make_dense(maker, f"{name}.wk_b", m.kv_lora_rank,
                                 h * m.qk_nope_dim, (None, L.HEADS)),
            "wv_b": L.make_dense(maker, f"{name}.wv_b", m.kv_lora_rank,
                                 h * m.v_head_dim, (None, L.HEADS)),
            "wo": L.make_dense(maker, f"{name}.wo", h * m.v_head_dim, d,
                               (L.HEADS, L.EMBED)),
            "kv_norm": L.make_rms_norm(maker, f"{name}.kv_norm",
                                       m.kv_lora_rank),
        }
        if m.q_lora_rank:
            p["wq_a"] = L.make_dense(maker, f"{name}.wq_a", d, m.q_lora_rank,
                                     (L.EMBED, None))
            p["wq"] = L.make_dense(maker, f"{name}.wq", m.q_lora_rank,
                                   h * (m.qk_nope_dim + m.qk_rope_dim),
                                   (None, L.HEADS))
            p["q_norm"] = L.make_rms_norm(maker, f"{name}.q_norm",
                                          m.q_lora_rank)
        return p
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
               dtype=torch.bfloat16, device=None) -> dict:
    """An empty KV cache of ``dtype`` on ``device`` (the CUDA card unless
    named): ``max_len`` slots, or the window's; ``pos`` -1 marks a slot
    empty."""
    device = resolve_device(device)
    slots = min(spec.window, max_len) if spec.window else max_len
    pos = torch.full((batch, slots), -1, dtype=torch.int32, device=device)
    if spec.mla is not None:
        m = spec.mla
        return {"ckv": torch.zeros((batch, slots, m.kv_lora_rank),
                                   dtype=dtype, device=device),
                "kr": torch.zeros((batch, slots, m.qk_rope_dim), dtype=dtype,
                                  device=device),
                "pos": pos}
    shape = (batch, slots, spec.num_kv_heads, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": pos,
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


def decode_axes(dist, batch: int, slots: int):
    """(batch_axes, seq_axes) for the flash-decode layout, or (None, None)
    if the cell can't use it (no mesh, or an indivisible slot count).
    ``batch``: the global batch; when the data axes divide it, batch goes
    over them and slots over 'model', else slots over every axis."""
    if dist is None or getattr(dist, "mesh", None) is None:
        return None, None
    dsize = shd.axes_size(dist.mesh, dist.data_axes)
    if batch % dsize == 0:
        batch_axes = tuple(dist.data_axes)
        seq_axes = (dist.model_axis,)
    else:
        batch_axes = ()
        seq_axes = tuple(dist.data_axes) + (dist.model_axis,)
    if slots % shd.axes_size(dist.mesh, seq_axes) != 0:
        return None, None
    return batch_axes, seq_axes


def _global_batch(dist, b: int) -> int:
    """The global decode batch of a rank holding ``b`` rows: the port
    splits a decode batch over the data axes."""
    return b * shd.axes_size(dist.mesh, dist.data_axes)


def flash_decode_gqa(q, k, v, pos, q_pos, spec: AttnSpec,
                     dist) -> torch.Tensor:
    """The reference's flash-decode (its ``shard_map`` body, run by every
    rank): each rank attends over its slots of the cache, and only the
    per-head (max, sum, weighted V) statistics cross ranks — an
    ``all_reduce(MAX)`` of the max, then ``all_reduce(SUM)`` of the
    rescaled sum and weighted V over the sequence group.  P is cast to the
    cache's dtype before P V (float32 accumulation), as in the reference.

    q: (B, 1, H, hd), the real heads of this rank's batch rows (the
    batch split over the data axes: ``_global_batch``); k / v: (B, S,
    KVH, hd) and pos (B, S): the whole cache of those rows, whose slots
    [i S/n, (i+1) S/n) this rank reads (i its index over the sequence
    axes, n their size: ``sharding.local_shard``); q_pos: (B, 1).  Plain
    PyTorch: the reference computes this with XLA ops, no Pallas kernel.
    """
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    _, seq_axes = decode_axes(dist, _global_batch(dist, b), k.shape[1])
    if seq_axes is None:
        raise ValueError(f"no flash-decode layout for {b} rows and "
                         f"{k.shape[1]} slots on this mesh")
    k_l, v_l, pos_l = (shd.local_shard(t, (None, seq_axes), dist.mesh)
                       for t in (k, v, pos))
    qg = q.reshape(b, 1, kvh, g, hd)
    scores = _f32_einsum("bqkgd,bskd->bkgqs", qg, k_l) * (hd ** -0.5)
    bias = _mask_bias(q_pos, pos_l, spec.window, spec.causal)
    scores = scores + bias[:, None, None]
    m_loc = scores.amax(-1)                                # (b,kvh,g,1)
    p = torch.exp(scores - m_loc[..., None])
    l_loc = p.sum(-1)
    o_loc = _f32_einsum("bkgqs,bskd->bkgqd", p.to(v_l.dtype), v_l)
    group = shd.axes_group(dist.mesh, seq_axes)
    m_g = m_loc.clone()
    torch.distributed.all_reduce(m_g, op=torch.distributed.ReduceOp.MAX,
                                 group=group)
    c = torch.exp(m_loc - m_g)
    l_g = l_loc * c
    o_g = o_loc * c[..., None]
    torch.distributed.all_reduce(l_g, group=group)
    torch.distributed.all_reduce(o_g, group=group)
    out = o_g / torch.clamp_min(l_g, 1e-30)[..., None]
    return out.reshape(b, 1, h, hd).to(q.dtype)


def attention(params: dict, x: torch.Tensor, positions: torch.Tensor,
              spec: AttnSpec, ctx: L.PhotonicCtx = L.EXACT_CTX,
              name: str = "attn",
              cache: Optional[dict] = None,
              cache_index=None,
              kv_source: Optional[torch.Tensor] = None,
              kv_positions: Optional[torch.Tensor] = None,
              attn_impl: str = "auto", dist=None,
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self- or cross-attention.

    x: (B, S, D); positions: (B, S) absolute positions of x.
    cache + cache_index=None  -> prefill: fill the cache's slots.
    cache + cache_index=i     -> decode: write at slot i % slots in place,
                                 S must be 1; i an int or a 0-d tensor.
    kv_source                 -> cross-attention (no cache, no rope).
    attn_impl                 -> 'auto' | 'kernel' | 'ref' | 'dense' (see
                                 the module docstring).
    dist                      -> a moe.DistCtx: on a mesh, a GQA decode
                                 step takes ``flash_decode_gqa``.
    Returns (out, updated_cache_or_None).
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    if spec.mla is not None:
        return _mla_attention(params, x, positions, spec, ctx, name, cache,
                              cache_index, attn_impl)
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
            if dist is not None and dist.mesh is not None and decode_axes(
                    dist, _global_batch(dist, b), slots)[1] is not None:
                fo = flash_decode_gqa(q[:, :, :spec.num_heads], k, v,
                                      cache["pos"], positions, spec, dist)
                if h != spec.num_heads:
                    fo = torch.nn.functional.pad(
                        fo, (0, 0, 0, h - spec.num_heads))
                return L.dense(params["wo"], fo.reshape(b, s, h * hd), ctx,
                               f"{name}.wo"), new_cache
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek v2/v3)
# ---------------------------------------------------------------------------
def _mla_qkr(params, x, positions, spec, ctx, name):
    b, s, _ = x.shape
    m, h = spec.mla, spec.num_heads
    if "wq_a" in params:
        qa = L.dense(params["wq_a"], x, ctx, f"{name}.wq_a")
        qa = L.rms_norm(params["q_norm"], qa)
        q = L.dense(params["wq"], qa, ctx, f"{name}.wq")
    else:
        q = L.dense(params["wq"], x, ctx, f"{name}.wq")
    q = q.reshape(b, s, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = L.apply_rope(q_rope, positions, spec.rope_theta)
    kv_a = L.dense(params["wkv_a"], x, ctx, f"{name}.wkv_a")
    ckv, k_rope = torch.split(kv_a, [m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    ckv = L.rms_norm(params["kv_norm"], ckv)
    k_rope = L.apply_rope(k_rope[:, :, None, :], positions,
                          spec.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, ckv, k_rope


def _mla_flash(q_nope, q_rope, k_nope, k_rope, v, spec: AttnSpec,
               impl: str):
    """MLA self-attention over the prompt through the flash kernel (or
    its plain version): Q = [q_nope, q_rope] and K = [k_nope, k_rope
    broadcast over the heads] make one head of D = nope + rope, whose
    kernel scale D^-0.5 is MLA's; V is zero-padded from v_head_dim to D
    and the output sliced back."""
    b, s, h, _ = q_nope.shape
    vd = v.shape[-1]
    q = torch.cat([q_nope, q_rope], dim=-1)
    d = q.shape[-1]
    if vd > d:
        raise ValueError(f"the flash route takes v_head_dim <= "
                         f"qk_nope_dim + qk_rope_dim, got {vd} > {d}")
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, -1)],
                  dim=-1)
    v = torch.nn.functional.pad(v, (0, d - vd))

    def fold(t):
        return t.transpose(1, 2).reshape(b * h, s, d)

    o = kops.flash_attention(fold(q), fold(k), fold(v), causal=spec.causal,
                             window=spec.window, impl=impl)
    return o.reshape(b, h, s, d)[..., :vd].transpose(1, 2)


def _mla_attention(params, x, positions, spec, ctx, name, cache,
                   cache_index, attn_impl):
    """MLA.  The prompt (prefill, or no cache) materialises per-head K and
    V through ``wk_b`` / ``wv_b`` (photonic under a ctx) and attends on
    the dense route or the flash route (``attn_impl``, as for GQA); a
    decode step writes the compressed cache ``ckv`` / ``kr`` / ``pos`` at
    ``index % slots`` in place and scores against ``ckv`` directly with
    the absorbed weights (``wk_b`` and ``wv_b`` as raw products, exact
    under a ctx, as in the reference)."""
    b, s, _ = x.shape
    m, h = spec.mla, spec.num_heads
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    q_nope, q_rope, ckv, k_rope = _mla_qkr(params, x, positions, spec, ctx,
                                           name)
    new_cache = None
    kv_ckv, kv_kr, kpos = ckv, k_rope, positions
    if cache is not None and cache_index is None:      # prefill into cache
        new_cache = {key: cache[key].clone() for key in ("ckv", "kr", "pos")}
        new_cache["ckv"][:, :s] = ckv.to(cache["ckv"].dtype)
        new_cache["kr"][:, :s] = k_rope.to(cache["kr"].dtype)
        new_cache["pos"][:, :s] = positions.to(torch.int32)
    elif cache is not None:                            # absorbed decode
        if s != 1:
            raise ValueError(f"decode takes one token, got S={s}")
        if not isinstance(cache_index, torch.Tensor):
            cache_index = torch.full((), int(cache_index),
                                     dtype=torch.int64, device=x.device)
        slot = cache_index.reshape(1).long() % cache["ckv"].shape[1]
        cache["ckv"].index_copy_(1, slot, ckv.to(cache["ckv"].dtype))
        cache["kr"].index_copy_(1, slot, k_rope.to(cache["kr"].dtype))
        cache["pos"].index_copy_(1, slot, positions.to(torch.int32))
        new_cache = cache
        kv_ckv, kv_kr, kpos = cache["ckv"], cache["kr"], cache["pos"]

    if cache_index is not None:
        # Absorbed-weight decode: score against c_kv directly.  q_abs is
        # rounded to the activations' dtype, the probabilities to the
        # cache's.
        wk_b = params["wk_b"]["w"].reshape(m.kv_lora_rank, h, m.qk_nope_dim)
        q_abs = _f32_einsum("bqhd,rhd->bqhr", q_nope, wk_b).to(
            torch.result_type(q_nope, wk_b))
        scores = (_f32_einsum("bqhr,bsr->bhqs", q_abs, kv_ckv) +
                  _f32_einsum("bqhd,bsd->bhqs", q_rope, kv_kr))
        bias = _mask_bias(positions, kpos, spec.window, spec.causal)
        probs = torch.softmax(scores * scale + bias[:, None], dim=-1)
        ctx_r = _f32_einsum("bhqs,bsr->bqhr", probs.to(kv_ckv.dtype),
                            kv_ckv).to(kv_ckv.dtype)
        wv_b = params["wv_b"]["w"].reshape(m.kv_lora_rank, h, m.v_head_dim)
        out = _f32_einsum("bqhr,rhv->bqhv", ctx_r, wv_b).to(
            torch.result_type(ctx_r, wv_b))
    else:
        # The prompt: materialise per-head K and V.
        k_nope = L.dense(params["wk_b"], kv_ckv, ctx, f"{name}.wk_b") \
            .reshape(b, s, h, m.qk_nope_dim)
        v = L.dense(params["wv_b"], kv_ckv, ctx, f"{name}.wv_b") \
            .reshape(b, s, h, m.v_head_dim)
        if attn_impl != "dense" and s > 1:
            out = _mla_flash(q_nope, q_rope, k_nope, kv_kr, v, spec,
                             attn_impl)
        else:
            scores = (_f32_einsum("bqhd,bshd->bhqs", q_nope, k_nope) +
                      _f32_einsum("bqhd,bsd->bhqs", q_rope, kv_kr))
            bias = _mask_bias(positions, kpos, spec.window, spec.causal)
            probs = torch.softmax(scores * scale + bias[:, None], dim=-1)
            out = _f32_einsum("bhqs,bshv->bqhv", probs.to(v.dtype),
                              v).to(v.dtype)
    out = L.dense(params["wo"], out.reshape(b, s, h * m.v_head_dim), ctx,
                  f"{name}.wo")
    return out, new_cache
