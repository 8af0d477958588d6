"""Uniform model API over the architectures the port runs (counterpart of
``repro.models.model_zoo``).

Dispatches on ``cfg.family``: 'audio' -> ``encdec`` (whisper), everything
else -> ``transformer``.

    init_params(cfg, seed, device)            -- seeded params
    init_caches(cfg, batch, max_len, dtype, device)
    prefill_fn / decode_fn                    -- serving
    params_from_jax(tree, device)             -- a reference param tree

``init_params`` and ``init_caches`` run on the CUDA card unless the caller
names another device (``device="cpu"`` runs the plain PyTorch versions);
``prefill_fn`` and ``decode_fn`` run where their params are.  The port runs
every family of the zoo: ssm (mamba2), dense (qwen2, h2o-danube3,
gemma3), hybrid (zamba2), vlm (llava), moe (deepseek v2/v3: MoE + MLA;
v3's MTP params) and audio (whisper).  ``loss_fn`` waits for the
training slice.  Batches are dicts: {"tokens"} (+ "frames"
(B, encoder_seq, WHISPER_FRAME_FEAT) for audio, "patches" (B,
num_image_tokens, vision_embed_dim) for vlm) — the modality frontends are
stubs, as in the reference, so frames and patches arrive as precomputed
features.  The serving state is {"layers": caches} (+ "enc_out", the
encoder's output, for audio).  ``params_from_jax`` carries any reference
tree across leaf by leaf: attention's QKV biases and its
``head_pad``-padded ``wq`` / ``wo``, the (E, D, F) expert tensors and
v3's ``mtp`` subtree as they are.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import encdec, transformer

WHISPER_FRAME_FEAT = 80   # log-mel bins fed to the (stubbed) conv frontend


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.family != "audio":
        transformer.check_supported(cfg)


def init_params(cfg: ArchConfig, seed: int, device=None) -> dict:
    """Seeded params of ``cfg.dtype`` on ``device`` (the CUDA card unless
    named); the same values on every device."""
    if cfg.family == "audio":
        return encdec.init_params(cfg, seed, device)
    return transformer.init_params(cfg, seed, device)


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> dict:
    if cfg.family == "audio":
        return encdec.init_caches(cfg, batch, max_len, dtype, device)
    return transformer.init_caches(cfg, batch, max_len, dtype, device)


def _check_device(params: dict, tokens: torch.Tensor) -> None:
    table = params["embed"]["table"]
    if tokens.device != table.device:
        raise ValueError(f"tokens are on {tokens.device}, params on "
                         f"{table.device}")


def prefill_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
               caches, ctx: L.PhotonicCtx = L.EXACT_CTX,
               ssm_impl: str = "auto", attn_impl: str = "auto"):
    """Prefill on the params' device.  ssm_impl: the SSD scan's
    ('auto' | 'kernel' | 'ref', see ``kernels.ops.ssd_scan``); attn_impl:
    the prompt's self-attention ('auto' | 'kernel' | 'ref' for the flash
    kernel or its plain version, 'dense' for the reference's default path;
    see ``models.attention``).  Audio: ``batch["frames"]`` is encoded
    once and its output kept in the state; vlm: ``batch["patches"]``
    overwrite the first positions' embeddings."""
    _check_supported(cfg)
    _check_device(params, batch["tokens"])
    if cfg.family == "audio":
        logits, caches, enc_out = encdec.prefill(
            params, batch["tokens"], batch["frames"], cfg, caches, ctx,
            attn_impl)
        return logits, {"layers": caches, "enc_out": enc_out}
    logits, caches = transformer.prefill(
        params, batch["tokens"], cfg, caches, ctx, ssm_impl, attn_impl,
        prefix_embeds=batch.get("patches"))
    return logits, {"layers": caches}


def decode_fn(params, token: torch.Tensor, index, cfg: ArchConfig,
              state, ctx: L.PhotonicCtx = L.EXACT_CTX,
              attn_impl: str = "auto"):
    """One decode step on the params' device.  index: the token's
    position, a Python int or a 0-d integer tensor on that device.  The
    caches in ``state`` are updated in place (``transformer.decode_step``);
    a caller that needs the state from before the step keeps a copy."""
    _check_supported(cfg)
    _check_device(params, token)
    if cfg.family == "audio":
        logits, caches = encdec.decode_step(params, token, index,
                                            state["enc_out"], cfg,
                                            state["layers"], ctx, attn_impl)
        return logits, {**state, "layers": caches}
    logits, caches = transformer.decode_step(params, token, index, cfg,
                                             state["layers"], ctx, attn_impl)
    return logits, {**state, "layers": caches}


def _leaf_from_numpy(leaf, device: torch.device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # torch.from_numpy refuses numpy's bfloat16 extension type; the
        # round trip through float32 is exact.
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_jax(tree, device=None):
    """The reference's nested param tree (numpy or array leaves) as the
    port's: the same keys and shapes, each leaf's dtype kept (bfloat16
    included), on ``device`` (the CUDA card unless named)."""
    device = resolve_device(device)
    return transformer.tree_map(lambda leaf: _leaf_from_numpy(leaf, device),
                                tree)
