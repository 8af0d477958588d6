"""Whisper-style encoder-decoder backbone, the audio family (counterpart of
``repro.models.encdec``).

The conv frontend is a STUB, as in the reference: ``encode`` consumes
precomputed frame features (B, frames, feat) and projects them in.
Everything downstream — the bidirectional encoder, the causal decoder with
cross-attention, the serving caches — is real.  Whisper details kept:
learned positional embeddings (no RoPE), GELU MLPs (the tanh form,
``layers.gelu``), LayerNorm, pre-norm blocks.  The attention specs do not
take the config's ``head_pad``: whisper runs its real heads unpadded.

Serving: ``init_caches`` -> ``prefill`` (encodes the frames once and
returns the encoder output beside the caches) -> ``decode_step`` (the
cross-attention reads that output every step).  As in
``models/transformer``, ``init_params`` and ``init_caches`` place their
tensors on the CUDA card unless the caller names a device, the other
functions run where their inputs are, the prefill returns new caches and
a decode step writes its KV slot in place and returns the caches it was
given (so that it captures in a CUDA graph).  The flash route of
``attention`` runs the encoder's self-attention (non-causal) and the
decoder's over the prompt (causal, into the empty cache); cross-attention
and decode take the grouped einsum, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import (make_stacked, prompt_positions,
                                             step_positions, tree_map)

#: The decoder's learned positions: sized for a 32768-token cache plus
#: headroom, as the reference (real Whisper caps at 448 target positions).
DEC_POSITIONS = 33024


def _spec(cfg: ArchConfig, causal: bool, use_rope: bool = False
          ) -> A.AttnSpec:
    return A.AttnSpec(d_model=cfg.d_model, num_heads=cfg.num_heads,
                      num_kv_heads=cfg.num_kv_heads,
                      head_dim=cfg.resolved_head_dim, causal=causal,
                      use_rope=use_rope, qkv_bias=True)


def init_params(cfg: ArchConfig, seed: int, device=None) -> dict:
    """Seeded params of ``cfg.dtype`` on ``device`` (the CUDA card unless
    named)."""
    return _build_params(cfg, L.ParamMaker(seed, dtype=getattr(torch,
                                                               cfg.dtype),
                                           device=resolve_device(device)))


def param_specs(cfg: ArchConfig) -> dict:
    """The params' tree of logical-axis tuples."""
    return _build_params(cfg, L.ParamMaker(None))


def _build_params(cfg: ArchConfig, maker: L.ParamMaker) -> dict:
    d = cfg.d_model

    def enc_block(mk, nm):
        return {"ln1": L.make_layer_norm(mk, f"{nm}.ln1", d),
                "attn": A.make_attention(mk, f"{nm}.attn", _spec(cfg, False)),
                "ln2": L.make_layer_norm(mk, f"{nm}.ln2", d),
                "ffn": L.make_mlp(mk, f"{nm}.ffn", d, cfg.d_ff, gated=False)}

    def dec_block(mk, nm):
        return {"ln1": L.make_layer_norm(mk, f"{nm}.ln1", d),
                "self_attn": A.make_attention(mk, f"{nm}.self",
                                              _spec(cfg, True)),
                "ln_x": L.make_layer_norm(mk, f"{nm}.lnx", d),
                "cross_attn": A.make_attention(mk, f"{nm}.cross",
                                               _spec(cfg, False)),
                "ln2": L.make_layer_norm(mk, f"{nm}.ln2", d),
                "ffn": L.make_mlp(mk, f"{nm}.ffn", d, cfg.d_ff, gated=False)}

    return {
        "frame_proj": L.make_dense(maker, "frame_proj",
                                   cfg.vision_embed_dim or 80, d,
                                   (None, L.EMBED)),
        "enc_pos": maker.param("enc_pos", (cfg.encoder_seq, d),
                               (None, L.EMBED), scale=0.02),
        "encoder": make_stacked(maker, "encoder", cfg.encoder_layers,
                                enc_block),
        "enc_ln": L.make_layer_norm(maker, "enc_ln", d),
        "embed": L.make_embedding(maker, "embed", cfg.vocab_size, d),
        "dec_pos": maker.param("dec_pos", (DEC_POSITIONS, d),
                               (None, L.EMBED), scale=0.02),
        "decoder": make_stacked(maker, "decoder", cfg.num_layers, dec_block),
        "dec_ln": L.make_layer_norm(maker, "dec_ln", d),
    }


def encode(params: dict, frames: torch.Tensor, cfg: ArchConfig,
           ctx: L.PhotonicCtx = L.EXACT_CTX,
           attn_impl: str = "auto") -> torch.Tensor:
    """frames: (B, T_frames, feat) precomputed frontend features (STUB) ->
    (B, T_frames, d_model)."""
    b, t, _ = frames.shape
    x = L.dense(params["frame_proj"], frames, ctx, "frame_proj")
    x = x + params["enc_pos"][:t][None].to(x.dtype)
    positions = prompt_positions(b, t, frames.device)
    spec = _spec(cfg, causal=False)
    for i in range(cfg.encoder_layers):
        p = tree_map(lambda a, i=i: a[i], params["encoder"])
        h, _ = A.attention(p["attn"], L.layer_norm(p["ln1"], x), positions,
                           spec, ctx, "enc.attn", attn_impl=attn_impl)
        x = x + h
        x = x + L.mlp(p["ffn"], L.layer_norm(p["ln2"], x), ctx, "enc.ffn",
                      act=L.gelu)
    return L.layer_norm(params["enc_ln"], x)


def _decoder_pass(params, tokens, positions, enc_out, cfg, ctx,
                  caches=None, cache_index=None, attn_impl="auto"):
    """The decoder over ``tokens`` at ``positions``: logits for every
    position and the caches (new ones from a prefill, ``caches`` itself,
    written in place, from a decode step, None without caches)."""
    x = L.embed(params["embed"], tokens)
    x = x + params["dec_pos"][positions.long()].to(x.dtype)
    self_spec = _spec(cfg, causal=True)
    cross_spec = _spec(cfg, causal=False)
    ncs = []
    for i in range(cfg.num_layers):
        p = tree_map(lambda a, i=i: a[i], params["decoder"])
        c = None if caches is None else \
            tree_map(lambda a, i=i: a[i], caches)["self"]
        h, nc = A.attention(p["self_attn"], L.layer_norm(p["ln1"], x),
                            positions, self_spec, ctx, "dec.self", c,
                            cache_index, attn_impl=attn_impl)
        x = x + h
        h, _ = A.attention(p["cross_attn"], L.layer_norm(p["ln_x"], x),
                           positions, cross_spec, ctx, "dec.cross",
                           kv_source=enc_out, attn_impl=attn_impl)
        x = x + h
        x = x + L.mlp(p["ffn"], L.layer_norm(p["ln2"], x), ctx, "dec.ffn",
                      act=L.gelu)
        ncs.append(nc)
    if caches is None:
        new_caches = None
    elif cache_index is not None:
        new_caches = caches
    else:
        new_caches = {"self": tree_map(lambda *a: torch.stack(a), *ncs)}
    x = L.layer_norm(params["dec_ln"], x)
    return L.unembed(params["embed"], x, ctx), new_caches


def forward(params: dict, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ArchConfig, ctx: L.PhotonicCtx = L.EXACT_CTX,
            attn_impl: str = "auto") -> torch.Tensor:
    """Teacher-forced training/scoring pass: (B, S) tokens + (B, T, feat)
    frames -> (B, S, vocab) logits.  Under grad every attention takes its
    plain, differentiable route whatever the card
    (``kernels.ops.resolve_impl``)."""
    b, s = tokens.shape
    enc_out = encode(params, frames, cfg, ctx, attn_impl)
    logits, _ = _decoder_pass(params, tokens,
                              prompt_positions(b, s, tokens.device), enc_out,
                              cfg, ctx, attn_impl=attn_impl)
    return logits


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> dict:
    """{"self": the decoder's KV caches, stacked over its layers}, of
    ``dtype`` on ``device`` (the CUDA card unless named)."""
    one = {"self": A.init_cache(_spec(cfg, causal=True), batch, max_len,
                                dtype, resolve_device(device))}
    return tree_map(
        lambda a: a[None].expand((cfg.num_layers,) + a.shape).clone(), one)


def prefill(params: dict, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ArchConfig, caches: dict,
            ctx: L.PhotonicCtx = L.EXACT_CTX, attn_impl: str = "auto"
            ) -> Tuple[torch.Tensor, dict, torch.Tensor]:
    """Encode ``frames`` and fill the decoder's caches from the prompt;
    returns (last-token logits, caches, encoder output)."""
    b, s = tokens.shape
    enc_out = encode(params, frames, cfg, ctx, attn_impl)
    logits, new_caches = _decoder_pass(
        params, tokens, prompt_positions(b, s, tokens.device), enc_out,
        cfg, ctx, caches, attn_impl=attn_impl)
    return logits[:, -1:], new_caches, enc_out


def decode_step(params: dict, token: torch.Tensor, index,
                enc_out: torch.Tensor, cfg: ArchConfig, caches: dict,
                ctx: L.PhotonicCtx = L.EXACT_CTX,
                attn_impl: str = "auto") -> Tuple[torch.Tensor, dict]:
    """One decode step against the encoder output ``enc_out``.  token:
    (B, 1); index: its position, a Python int or a 0-d integer tensor on
    the token's device.  ``caches`` are updated in place and returned."""
    index, positions = step_positions(index, token.shape[0], token.device)
    return _decoder_pass(params, token, positions, enc_out, cfg, ctx,
                         caches, cache_index=index, attn_impl=attn_impl)
