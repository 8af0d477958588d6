"""Uniform model API over the architectures the port runs (counterpart of
``repro.models.model_zoo``).

Dispatches on ``cfg.family``: 'audio' -> ``encdec`` (whisper), everything
else -> ``transformer``.

    init_params(cfg, seed, device)            -- seeded params
    loss_fn(params, batch, cfg, ...)          -- next-token CE (training)
    init_caches(cfg, batch, max_len, dtype, device)
    prefill_fn / decode_fn                    -- serving
    params_from_jax(tree, device)             -- a reference param tree
    adam_state_from_jax(state, device)        -- a reference AdamState

``init_params`` and ``init_caches`` run on the CUDA card unless the caller
names another device (``device="cpu"`` runs the plain PyTorch versions);
``prefill_fn`` and ``decode_fn`` run where their params are.  The port runs
every family of the zoo: ssm (mamba2), dense (qwen2, h2o-danube3,
gemma3), hybrid (zamba2), vlm (llava), moe (deepseek v2/v3: MoE + MLA;
v3's MTP params) and audio (whisper).  Batches are dicts: {"tokens"}
(+ "targets" for ``loss_fn``, + "frames"
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
from repro_torch.optim.optimizer import AdamState

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


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over every position, in float32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return -torch.mean(ll)


def loss_fn(params: dict, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            ctx: L.PhotonicCtx = L.EXACT_CTX, remat: bool = True,
            ssm_impl: str = "auto", attn_impl: str = "auto",
            mtp_weight: float = 0.0) -> torch.Tensor:
    """Next-token CE (+ optional DeepSeek-V3 MTP auxiliary loss), a 0-d
    float32 tensor.

    Audio runs ``encdec.forward`` on ``batch["frames"]``; the others run
    ``transformer.forward`` (``remat`` as there; the VLM's
    ``batch["patches"]``) to the final hidden states, and the CE head is
    a plain matmul with the embedding table (or ``lm_head``) — never
    photonic, as in the reference.  ``mtp_weight`` > 0 with
    ``cfg.mtp_depth`` > 0 adds the MTP head's CE
    (``transformer.mtp_hidden``) against the targets shifted by one.
    Under grad the SSD scan and attention resolve ``"auto"`` to their
    plain, differentiable routes (``kernels.ops.resolve_impl``); photonic
    GEMMs keep the TAOM kernel (straight-through backward).  The
    reference's ``dist`` argument and its vocab-sharded CE
    (``parallel/sharded_ce.py``) wait for distribution (ROADMAP A9): the
    port computes the CE on one device."""
    _check_supported(cfg)
    _check_device(params, batch["tokens"])
    if cfg.family == "audio":
        logits = encdec.forward(params, batch["tokens"], batch["frames"],
                                cfg, ctx, attn_impl)
        return _xent(logits, batch["targets"])
    table = transformer._head(params, cfg)["table"]
    hidden = transformer.forward(
        params, batch["tokens"], cfg, ctx, remat=remat, ssm_impl=ssm_impl,
        attn_impl=attn_impl, prefix_embeds=batch.get("patches"),
        return_hidden=True)
    loss = _xent(hidden @ table.T, batch["targets"])
    if mtp_weight > 0.0 and cfg.mtp_depth > 0:
        h_mtp = transformer.mtp_hidden(params, hidden, batch["tokens"], cfg,
                                       ctx, attn_impl)
        loss = loss + mtp_weight * _xent(h_mtp @ table.T,
                                         batch["targets"][:, 1:])
    return loss


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


def adam_state_from_jax(state, device=None) -> AdamState:
    """The reference's ``optim.optimizer.AdamState`` (numpy or array
    leaves) as the port's: step a 0-d int32 tensor, the moments' trees
    carried across as ``params_from_jax`` carries params, on ``device``
    (the CUDA card unless named)."""
    step, m, v = state
    device = resolve_device(device)
    return AdamState(
        torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
        params_from_jax(m, device), params_from_jax(v, device))
