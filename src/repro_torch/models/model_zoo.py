"""Uniform model API over the architectures the port runs (counterpart of
``repro.models.model_zoo``).

    init_params(cfg, seed, device)            -- seeded params
    init_caches(cfg, batch, max_len, dtype, device)
    prefill_fn / decode_fn                    -- serving
    params_from_jax(tree, device)             -- a reference param tree

``init_params`` and ``init_caches`` run on the CUDA card unless the caller
names another device (``device="cpu"`` runs the plain PyTorch versions);
``prefill_fn`` and ``decode_fn`` run where their params are.  The port runs
the ssm (mamba2) and dense (qwen2, h2o-danube3, gemma3) families; the
others — ``audio`` (the encoder-decoder), ``vlm``, ``hybrid`` and ``moe``
— raise ``NotImplementedError`` at entry naming their ROADMAP item.
``loss_fn`` waits for the training slice.  Batches are dicts: {"tokens"}.
``params_from_jax`` carries any reference tree across leaf by leaf:
attention's QKV biases and its ``head_pad``-padded ``wq`` / ``wo`` as they
are.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer


def init_params(cfg: ArchConfig, seed: int, device=None) -> dict:
    """Seeded params of ``cfg.dtype`` on ``device`` (the CUDA card unless
    named); the same values on every device."""
    return transformer.init_params(cfg, seed, resolve_device(device))


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> dict:
    return transformer.init_caches(cfg, batch, max_len, dtype,
                                   resolve_device(device))


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
    see ``models.attention``)."""
    transformer.check_supported(cfg)
    _check_device(params, batch["tokens"])
    logits, caches = transformer.prefill(params, batch["tokens"], cfg,
                                         caches, ctx, ssm_impl, attn_impl)
    return logits, {"layers": caches}


def decode_fn(params, token: torch.Tensor, index, cfg: ArchConfig,
              state, ctx: L.PhotonicCtx = L.EXACT_CTX,
              attn_impl: str = "auto"):
    """One decode step on the params' device.  index: the token's
    position, a Python int or a 0-d integer tensor on that device.  The
    caches in ``state`` are updated in place (``transformer.decode_step``);
    a caller that needs the state from before the step keeps a copy."""
    transformer.check_supported(cfg)
    _check_device(params, token)
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
