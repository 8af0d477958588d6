"""Decoder-only LM assembly (counterpart of ``repro.models.transformer``).

A config resolves to a *layer plan*: a short list of groups, each a stack
of ``repeats`` identical layers.  Params keep the reference's leading stack
axis, so one tree map carries a reference param tree across; the port runs
the stack as a Python loop (serving only: no remat, no ``lax.scan``).

Families run so far: ``ssm`` (mamba2).  The others (dense and local:global
attention, MoE + MLA, the VLM projector, MTP, the hybrid's shared
attention) raise ``NotImplementedError`` naming their ROADMAP item.  The
reference's ``dist`` context is dropped: the port runs on one device.

Serving: ``init_caches`` -> ``prefill`` -> ``decode_step`` with explicit
cache trees throughout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

# What each family still needs, by ROADMAP item.
_UNPORTED = {
    "dense": "attention (ROADMAP A7a, the next slice)",
    "vlm": "attention and the VLM projector (ROADMAP A7a, A7d)",
    "hybrid": "the shared attention block (ROADMAP A7b)",
    "moe": "attention, MoE and MLA (ROADMAP A7a, A7c)",
    "audio": "the encoder-decoder (ROADMAP A7d)",
}


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port cannot run."""
    if cfg.family in _UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family needs "
            f"{_UNPORTED[cfg.family]}, not ported yet; the port runs the "
            f"ssm family (mamba2)")
    if cfg.family != "ssm":
        raise NotImplementedError(f"{cfg.name}: unknown family "
                                  f"{cfg.family!r}")


# ---------------------------------------------------------------------------
# Layer plans (copied whole from the reference)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    kind: str        # 'attn_dense' | 'attn_moe' | 'mamba' | 'mamba_shared'
    repeats: int     # stack length
    period: Tuple[str, ...] = ()   # sub-layer kinds within one superblock
    windows: Tuple[int, ...] = ()  # per-sub-layer attention window (0=full)


def layer_plan(cfg: ArchConfig) -> List[Group]:
    if cfg.family == "ssm":
        return [Group("mamba", "mamba", cfg.num_layers)]
    if cfg.family == "hybrid":
        p = cfg.shared_attn_period
        full, rem = divmod(cfg.num_layers, p)
        groups = [Group("hybrid", "mamba_shared", full)]
        if rem:
            groups.append(Group("tail", "mamba", rem))
        return groups
    if cfg.local_global_period:
        p = cfg.local_global_period
        assert cfg.num_layers % p == 0, (cfg.num_layers, p)
        wins = tuple(cfg.local_window if i < p - 1 else 0 for i in range(p))
        kinds = tuple("attn_dense" for _ in range(p))
        return [Group("localglobal", "attn_dense", cfg.num_layers // p,
                      period=kinds, windows=wins)]
    if cfg.moe is not None:
        groups = []
        fd = cfg.moe.first_dense_layers
        if fd:
            groups.append(Group("dense_head", "attn_dense", fd))
        groups.append(Group("moe_body", "attn_moe", cfg.num_layers - fd))
        return groups
    return [Group("body", "attn_dense", cfg.num_layers)]


# ---------------------------------------------------------------------------
# Trees of tensors (the reference's jax.tree.map over nested dicts)
# ---------------------------------------------------------------------------
def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------
def _make_sublayer(maker: L.ParamMaker, name: str, cfg: ArchConfig) -> dict:
    """A ``mamba`` sublayer (the only kind of the ssm family)."""
    return {"mamba": S.make_mamba(maker, f"{name}.mamba", cfg.d_model,
                                  cfg.ssm),
            "ln": L.make_rms_norm(maker, f"{name}.ln", cfg.d_model)}


def make_stacked(maker: L.ParamMaker, name: str, n: int, build_fn) -> dict:
    """Stack n structurally-identical param trees on a leading STACK axis."""
    parts = [build_fn(maker, f"{name}.{i}") for i in range(n)]
    return tree_map(lambda *xs: torch.stack(xs), *parts)


def init_params(cfg: ArchConfig, seed: int,
                device: torch.device = torch.device("cpu")) -> dict:
    """Seeded params of ``cfg.dtype`` on ``device`` (each tensor drawn from
    its own stream: ``layers.ParamMaker``)."""
    check_supported(cfg)
    maker = L.ParamMaker(seed, dtype=getattr(torch, cfg.dtype),
                         device=device)
    p: Dict[str, Any] = {
        "embed": L.make_embedding(maker, "embed", cfg.vocab_size,
                                  cfg.d_model),
        "final_ln": L.make_rms_norm(maker, "final_ln", cfg.d_model),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = {"table": maker.param(
            "lm_head.table", (cfg.vocab_size, cfg.d_model),
            (L.VOCAB, L.EMBED), scale=cfg.d_model ** -0.5)}
    for g in layer_plan(cfg):
        p[g.name] = {"stack": make_stacked(
            maker, g.name, g.repeats,
            lambda mk, nm: _make_sublayer(mk, nm, cfg))}
    return p


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def _run_sublayer(p, x, cfg, ctx, name, cache=None, cache_index=None,
                  ssm_impl="auto", return_state=False):
    """A ``mamba`` sublayer: prefill (full sequence) or one decode step."""
    h = L.rms_norm(p["ln"], x)
    if cache_index is not None:
        out, st = S.mamba_decode_step(p["mamba"], h, cfg.d_model, cfg.ssm,
                                      cache, ctx, name)
    else:
        out, st = S.mamba_block(p["mamba"], h, cfg.d_model, cfg.ssm, ctx,
                                name, state=cache, return_state=return_state,
                                impl=ssm_impl)
    return x + out, st


def _scan_group(p, x, cfg, g: Group, ctx, caches=None, cache_index=None,
                ssm_impl="auto", return_state=False):
    """Run one plan group layer by layer; returns (x, new_caches_or_None).
    Every layer's call sites are named after the group, as in the
    reference's scanned body."""
    stacked = p["stack"]
    new_caches = []
    for i in range(g.repeats):
        layer_p = tree_map(lambda a, i=i: a[i], stacked)
        c = None if caches is None else tree_map(lambda a, i=i: a[i], caches)
        x, nc = _run_sublayer(layer_p, x, cfg, ctx, g.name, c, cache_index,
                              ssm_impl, return_state)
        new_caches.append(nc)
    if new_caches[-1] is None or not (caches is not None or return_state):
        return x, None
    return x, tree_map(lambda *a: torch.stack(a), *new_caches)


def _head(params: dict, cfg: ArchConfig) -> dict:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            ctx: L.PhotonicCtx = L.EXACT_CTX,
            ssm_impl: str = "auto") -> torch.Tensor:
    """Scoring forward: tokens (B, S) -> logits (B, S, vocab)."""
    check_supported(cfg)
    x = L.embed(params["embed"], tokens)
    for g in layer_plan(cfg):
        x, _ = _scan_group(params[g.name], x, cfg, g, ctx, ssm_impl=ssm_impl)
    x = L.rms_norm(params["final_ln"], x)
    return L.unembed(_head(params, cfg), x, ctx)


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------
def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16,
                device: torch.device = torch.device("cpu")) -> dict:
    """Zero caches with a leading stack axis per group.  (Mamba state is
    float32 and O(1) in ``max_len``; ``dtype`` is the attention KV cache's,
    kept for the reference's signature.)"""
    check_supported(cfg)
    del max_len, dtype
    caches = {}
    for g in layer_plan(cfg):
        one = S.init_state(cfg.d_model, cfg.ssm, batch, device=device)
        caches[g.name] = tree_map(
            lambda a: a[None].expand((g.repeats,) + a.shape).clone(), one)
    return caches


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            caches: dict, ctx: L.PhotonicCtx = L.EXACT_CTX,
            ssm_impl: str = "auto") -> Tuple[torch.Tensor, dict]:
    """Fill caches from a prompt; returns (last-token logits, caches)."""
    check_supported(cfg)
    x = L.embed(params["embed"], tokens)
    new_caches = {}
    for g in layer_plan(cfg):
        x, nc = _scan_group(params[g.name], x, cfg, g, ctx,
                            caches=caches[g.name], ssm_impl=ssm_impl,
                            return_state=True)
        new_caches[g.name] = nc
    x = L.rms_norm(params["final_ln"], x[:, -1:])
    return L.unembed(_head(params, cfg), x, ctx), new_caches


def decode_step(params: dict, token: torch.Tensor, index: int,
                cfg: ArchConfig, caches: dict,
                ctx: L.PhotonicCtx = L.EXACT_CTX
                ) -> Tuple[torch.Tensor, dict]:
    """One decode step.  token: (B, 1) integer; index: its position (what
    attention's cache needs; the mamba state does not use it)."""
    check_supported(cfg)
    x = L.embed(params["embed"], token)
    new_caches = {}
    for g in layer_plan(cfg):
        x, nc = _scan_group(params[g.name], x, cfg, g, ctx,
                            caches=caches[g.name], cache_index=index)
        new_caches[g.name] = nc
    x = L.rms_norm(params["final_ln"], x)
    return L.unembed(_head(params, cfg), x, ctx), new_caches
