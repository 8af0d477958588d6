"""Decoder-only LM assembly (counterpart of ``repro.models.transformer``).

A config resolves to a *layer plan*: a short list of groups, each a stack
of ``repeats`` identical superblocks.  Params keep the reference's leading
stack axis, so one tree map carries a reference param tree across; the
port runs the stack as a Python loop (no ``lax.scan``).

Families run: ``ssm`` (mamba2), ``dense`` (qwen2, h2o-danube3 with its
sliding window, gemma3's local:global superblocks), ``hybrid`` (zamba2:
mamba superblocks with ONE shared attention block applied after each —
shared params, a KV cache per superblock), ``vlm`` (llava: the dense
backbone plus a projector whose output overwrites the embeddings of the
first ``num_image_tokens`` positions) and ``moe`` (deepseek v2/v3: MLA
attention, a dense head of ``first_dense_layers`` and ``attn_moe``
layers whose FFN is ``models/moe.py``; v3's multi-token-prediction
params and ``mtp_hidden``, which only training reads).  The
encoder-decoder (``audio``) is ``models/encdec.py``.  The reference's
``dist`` context is dropped: the port runs on one device.

Serving: ``init_caches`` -> ``prefill`` -> ``decode_step`` with explicit
cache trees throughout.  The prefill returns new caches; a decode step
updates the caches it is given in place and returns them, and takes its
position as a Python int or a 0-d tensor on the device, so that a step
captures in a CUDA graph (``launch/serve.DecodeGraph``).  ``ssm_impl``
picks the SSD scan's impl and ``attn_impl`` attention's
(``models.attention.attention``): the flash kernel runs each attention
layer's self-attention over the prompt.

Training: ``forward`` (what ``model_zoo.loss_fn`` calls) takes the
reference's ``remat`` and ``return_hidden``; under grad the SSD scan and
attention resolve ``"auto"`` to their plain, differentiable versions.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

_PORTED = ("ssm", "dense", "hybrid", "vlm", "moe")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a family this module does not
    run."""
    if cfg.family not in _PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the decoder-only transformer does not run the "
            f"{cfg.family!r} family (the audio family is models/encdec.py)")


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


def tree_leaves(tree, prefix: tuple = ()):
    """Yield ``(path, leaf)`` over nested dicts (keys in sorted order) and
    tuples; ``path`` is the tuple of keys and indices down to the leaf."""
    if isinstance(tree, (dict, tuple)):
        items = ((k, tree[k]) for k in sorted(tree)) \
            if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            yield from tree_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def attn_spec(cfg: ArchConfig, window: int = -1) -> A.AttnSpec:
    return A.AttnSpec(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        rope_theta=cfg.rope_theta, qkv_bias=cfg.qkv_bias,
        window=(cfg.sliding_window if window < 0 else window),
        mla=cfg.mla, head_pad=cfg.head_pad)


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------
def _make_sublayer(maker: L.ParamMaker, name: str, cfg: ArchConfig,
                   kind: str, window: int) -> dict:
    if kind == "mamba":
        return {"mamba": S.make_mamba(maker, f"{name}.mamba", cfg.d_model,
                                      cfg.ssm),
                "ln": L.make_rms_norm(maker, f"{name}.ln", cfg.d_model)}
    p = {
        "ln1": L.make_rms_norm(maker, f"{name}.ln1", cfg.d_model),
        "attn": A.make_attention(maker, f"{name}.attn",
                                 attn_spec(cfg, window)),
        "ln2": L.make_rms_norm(maker, f"{name}.ln2", cfg.d_model),
    }
    if kind == "attn_moe":
        p["ffn"] = M.make_moe(maker, f"{name}.ffn", cfg.d_model, cfg.moe)
    else:
        p["ffn"] = L.make_mlp(maker, f"{name}.ffn", cfg.d_model, cfg.d_ff)
    return p


def make_stacked(maker: L.ParamMaker, name: str, n: int, build_fn) -> dict:
    """Stack n structurally-identical param trees on a leading STACK axis.
    The n trees are built on threads: each parameter draws from its own
    named stream, so the values do not depend on the order, and PyTorch's
    draws and copies release the interpreter lock (a 7 B model's host-side
    draws would otherwise run on one core)."""
    with ThreadPoolExecutor(max_workers=min(n, os.cpu_count() or 1)) as pool:
        parts = list(pool.map(lambda i: build_fn(maker, f"{name}.{i}"),
                              range(n)))
    return tree_map(lambda *xs: torch.stack(xs), *parts)


def _make_group(maker: L.ParamMaker, cfg: ArchConfig, g: Group) -> dict:
    if g.kind == "mamba_shared":
        def build(mk, nm):
            return {f"m{i}": _make_sublayer(mk, f"{nm}.m{i}", cfg, "mamba", 0)
                    for i in range(cfg.shared_attn_period)}
        # ONE shared attention block (params reused at every superblock).
        return {"stack": make_stacked(maker, g.name, g.repeats, build),
                "shared_attn": _make_sublayer(maker, f"{g.name}.sh", cfg,
                                              "attn_dense", -1)}
    if g.period:   # local:global superblock
        def build(mk, nm):
            return {f"l{i}": _make_sublayer(mk, f"{nm}.l{i}", cfg,
                                            g.period[i], g.windows[i])
                    for i in range(len(g.period))}
    else:
        def build(mk, nm):
            return _make_sublayer(mk, nm, cfg, g.kind, -1)
    return {"stack": make_stacked(maker, g.name, g.repeats, build)}


def init_params(cfg: ArchConfig, seed: int, device=None) -> dict:
    """Seeded params of ``cfg.dtype`` on ``device`` (the CUDA card unless
    named; each tensor drawn from its own stream: ``layers.ParamMaker``)."""
    check_supported(cfg)
    maker = L.ParamMaker(seed, dtype=getattr(torch, cfg.dtype),
                         device=resolve_device(device))
    p: Dict[str, Any] = {
        "embed": L.make_embedding(maker, "embed", cfg.vocab_size,
                                  cfg.d_model),
        "final_ln": L.make_rms_norm(maker, "final_ln", cfg.d_model),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = {"table": maker.param(
            "lm_head.table", (cfg.vocab_size, cfg.d_model),
            (L.VOCAB, L.EMBED), scale=cfg.d_model ** -0.5)}
    if cfg.vision_embed_dim:
        p["projector"] = L.make_dense(maker, "projector",
                                      cfg.vision_embed_dim, cfg.d_model,
                                      (None, L.EMBED))
    if cfg.mtp_depth > 0:
        # DeepSeek-V3 multi-token prediction: a combiner + one extra block
        # per depth, sharing the embedding/head (arXiv:2412.19437 §2.2).
        p["mtp"] = {
            "ln_h": L.make_rms_norm(maker, "mtp.ln_h", cfg.d_model),
            "ln_e": L.make_rms_norm(maker, "mtp.ln_e", cfg.d_model),
            "proj": L.make_dense(maker, "mtp.proj", 2 * cfg.d_model,
                                 cfg.d_model, (None, L.EMBED)),
            "block": _make_sublayer(maker, "mtp.block", cfg, "attn_dense",
                                    -1),
            "final_ln": L.make_rms_norm(maker, "mtp.final_ln", cfg.d_model),
        }
    for g in layer_plan(cfg):
        p[g.name] = _make_group(maker, cfg, g)
    return p


def mtp_hidden(params: dict, hidden: torch.Tensor, tokens: torch.Tensor,
               cfg: ArchConfig, ctx: L.PhotonicCtx = L.EXACT_CTX,
               attn_impl: str = "auto") -> torch.Tensor:
    """Depth-1 MTP trunk: hidden states for predicting token t+2.

    hidden: (B, S, D) main-trunk final hidden; tokens: (B, S).  Returns
    (B, S-1, D) — position t predicts tokens[t+2] (the caller aligns the
    targets: ``model_zoo.loss_fn``).
    """
    mp = params["mtp"]
    b, s = tokens.shape
    h = L.rms_norm(mp["ln_h"], hidden[:, :-1])
    e = L.rms_norm(mp["ln_e"], L.embed(params["embed"], tokens[:, 1:]))
    x = L.dense(mp["proj"], torch.cat([h, e], dim=-1), ctx, "mtp.proj")
    positions = prompt_positions(b, s - 1, tokens.device)
    x, _ = _run_sublayer(mp["block"], x, positions, cfg, "attn_dense", 0,
                         ctx, "mtp.block", attn_impl=attn_impl)
    return L.rms_norm(mp["final_ln"], x)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def _run_sublayer(p, x, positions, cfg, kind, window, ctx, name, cache=None,
                  cache_index=None, ssm_impl="auto", attn_impl="auto",
                  return_state=False):
    """One sublayer: prefill (full sequence) or one decode step."""
    if kind == "mamba":
        h = L.rms_norm(p["ln"], x)
        if cache_index is not None:
            out, st = S.mamba_decode_step(p["mamba"], h, cfg.d_model,
                                          cfg.ssm, cache, ctx, name)
        else:
            out, st = S.mamba_block(p["mamba"], h, cfg.d_model, cfg.ssm, ctx,
                                    name, state=cache,
                                    return_state=return_state, impl=ssm_impl)
        return x + out, st
    spec = attn_spec(cfg, window)
    h, new_cache = A.attention(p["attn"], L.rms_norm(p["ln1"], x), positions,
                               spec, ctx, f"{name}.attn", cache, cache_index,
                               attn_impl=attn_impl)
    x = x + h
    h2 = L.rms_norm(p["ln2"], x)
    if kind == "attn_moe":
        ff = M.moe_ffn(p["ffn"], h2, cfg.moe, ctx, f"{name}.ffn")
    else:
        ff = L.mlp(p["ffn"], h2, ctx, f"{name}.ffn")
    return x + ff, new_cache


def _superblock(p, layer_p, x, positions, cfg, g: Group, ctx, layer_c,
                cache_index, ssm_impl, attn_impl, return_state):
    """One superblock of group ``g`` (the r-th layer's params ``layer_p``
    and cache slice ``layer_c``); returns (x, its new caches or None)."""
    if g.kind == "mamba_shared":
        nc = {}
        for i in range(cfg.shared_attn_period):
            key = f"m{i}"
            c = None if layer_c is None else layer_c[key]
            x, nc[key] = _run_sublayer(
                layer_p[key], x, positions, cfg, "mamba", 0, ctx,
                f"{g.name}.m{i}", c, cache_index, ssm_impl, attn_impl,
                return_state)
        c = None if layer_c is None else layer_c["sh"]
        x, nc["sh"] = _run_sublayer(
            p["shared_attn"], x, positions, cfg, "attn_dense", 0, ctx,
            f"{g.name}.sh", c, cache_index, ssm_impl, attn_impl,
            return_state)
        return x, nc
    if g.period:
        nc = {}
        for i, (kind, win) in enumerate(zip(g.period, g.windows)):
            key = f"l{i}"
            c = None if layer_c is None else layer_c[key]
            x, nc[key] = _run_sublayer(
                layer_p[key], x, positions, cfg, kind, win, ctx,
                f"{g.name}.{i}", c, cache_index, ssm_impl, attn_impl,
                return_state)
        return x, nc
    return _run_sublayer(layer_p, x, positions, cfg, g.kind, -1, ctx,
                         g.name, layer_c, cache_index, ssm_impl, attn_impl,
                         return_state)


def _scan_group(p, x, positions, cfg, g: Group, ctx, caches=None,
                cache_index=None, ssm_impl="auto", attn_impl="auto",
                return_state=False, remat=False):
    """Run one plan group superblock by superblock; returns (x,
    new_caches_or_None).  Call sites are named as in the reference's
    scanned body: after the group, ``{group}.{i}`` for the i-th sublayer
    of a local:global superblock, and ``{group}.m{i}`` / ``{group}.sh``
    for a hybrid superblock's i-th mamba sublayer and its shared
    attention block (PhotonicCtx noise sites hang on them).  A decode step
    (``cache_index`` set) writes each layer's slice of ``caches`` in
    place and returns ``caches`` itself.

    ``remat`` (a forward without caches only): each superblock runs under
    ``torch.utils.checkpoint`` — its activations are dropped after the
    forward and recomputed in the backward, as the reference's
    ``jax.checkpoint`` does (which keeps the matmul outputs; the port
    recomputes the whole superblock).  The recompute gives the same
    numbers: a photonic noise site draws from a generator seeded by its
    name (``layers.dense``), not from the global RNG, so the global RNG
    state is not stashed (``preserve_rng_state=False``)."""
    stacked = p["stack"]
    new_caches = []
    for r in range(g.repeats):
        layer_p = tree_map(lambda a, r=r: a[r], stacked)
        layer_c = None if caches is None else \
            tree_map(lambda a, r=r: a[r], caches)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda x_, lp: _superblock(p, lp, x_, positions, cfg, g,
                                           ctx, None, None, ssm_impl,
                                           attn_impl, False)[0],
                x, layer_p, use_reentrant=False, preserve_rng_state=False)
            nc = None
        else:
            x, nc = _superblock(p, layer_p, x, positions, cfg, g, ctx,
                                layer_c, cache_index, ssm_impl, attn_impl,
                                return_state)
        new_caches.append(nc)
    if cache_index is not None:
        return x, caches
    if new_caches[-1] is None or not (caches is not None or return_state):
        return x, None
    return x, tree_map(lambda *a: torch.stack(a), *new_caches)


def _head(params: dict, cfg: ArchConfig) -> dict:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def prompt_positions(b: int, s: int, device) -> torch.Tensor:
    """(B, S) int32 positions 0..S-1 of a prompt."""
    return torch.arange(s, dtype=torch.int32, device=device)[None] \
        .expand(b, s)


def step_positions(index, b: int, device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """A decode step's position: (index as a 0-d int64 tensor on
    ``device``, (B, 1) int32 positions).  ``index`` is a Python int (made
    with a fill, no host copy) or already a 0-d tensor there (what a CUDA
    graph of the step reads)."""
    if not isinstance(index, torch.Tensor):
        index = torch.full((), int(index), dtype=torch.int64, device=device)
    return index, index.to(torch.int32).reshape(1, 1).expand(b, 1)


def _embed(params: dict, tokens: torch.Tensor, ctx: L.PhotonicCtx,
           prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings; with ``prefix_embeds`` (B, S_img, vision_dim), the
    VLM's patch embeddings projected (call site "projector") and cast to
    the embeddings' dtype OVERWRITE the first S_img positions — the
    sequence length already counts them.  A prompt shorter than S_img
    raises (the reference would silently lengthen the sequence)."""
    x = L.embed(params["embed"], tokens)
    if prefix_embeds is None:
        return x
    n_img = prefix_embeds.shape[1]
    if tokens.shape[1] < n_img:
        raise ValueError(f"a prompt of {tokens.shape[1]} tokens is shorter "
                         f"than its {n_img} image positions")
    proj = L.dense(params["projector"], prefix_embeds, ctx, "projector")
    return torch.cat([proj.to(x.dtype), x[:, n_img:]], dim=1)


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            ctx: L.PhotonicCtx = L.EXACT_CTX, remat: bool = True,
            ssm_impl: str = "auto", attn_impl: str = "auto",
            prefix_embeds: Optional[torch.Tensor] = None,
            return_hidden: bool = False) -> torch.Tensor:
    """Training/scoring forward: tokens (B, S) -> logits (B, S, vocab);
    ``prefix_embeds`` as in ``_embed``.  ``remat``: recompute each
    superblock in the backward (``_scan_group``); the numbers are the same
    either way.  ``return_hidden=True`` returns the final-norm hidden
    states (B, S, D) instead of the logits (``model_zoo.loss_fn`` applies
    the head itself).  Under grad the SSD scan and attention take their
    plain, differentiable routes whatever the card
    (``kernels.ops.resolve_impl``)."""
    check_supported(cfg)
    b, s = tokens.shape
    x = _embed(params, tokens, ctx, prefix_embeds)
    positions = prompt_positions(b, s, tokens.device)
    for g in layer_plan(cfg):
        x, _ = _scan_group(params[g.name], x, positions, cfg, g, ctx,
                           ssm_impl=ssm_impl, attn_impl=attn_impl,
                           remat=remat)
    x = L.rms_norm(params["final_ln"], x)
    if return_hidden:
        return x
    return L.unembed(_head(params, cfg), x, ctx)


# ---------------------------------------------------------------------------
# Serving: caches, prefill, decode
# ---------------------------------------------------------------------------
def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> dict:
    """Zero caches with a leading stack axis per group on ``device`` (the
    CUDA card unless named): attention KV caches of ``dtype`` (``max_len``
    slots, or the window's), mamba state in float32 (O(1) in
    ``max_len``); a hybrid superblock holds its mamba sublayers' states
    ``m{i}`` and the shared attention block's KV cache ``sh``."""
    check_supported(cfg)
    device = resolve_device(device)
    caches = {}
    for g in layer_plan(cfg):
        def one(kind: str, window: int):
            if kind == "mamba":
                return S.init_state(cfg.d_model, cfg.ssm, batch,
                                    device=device)
            return A.init_cache(attn_spec(cfg, window), batch, max_len,
                                dtype, device)

        if g.kind == "mamba_shared":
            block = {f"m{i}": one("mamba", 0)
                     for i in range(cfg.shared_attn_period)}
            block["sh"] = one("attn_dense", 0)
        elif g.period:
            block = {f"l{i}": one(g.period[i], g.windows[i])
                     for i in range(len(g.period))}
        else:
            block = one(g.kind, cfg.sliding_window if g.kind != "mamba"
                        else 0)
        caches[g.name] = tree_map(
            lambda a: a[None].expand((g.repeats,) + a.shape).clone(), block)
    return caches


def prefill(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            caches: dict, ctx: L.PhotonicCtx = L.EXACT_CTX,
            ssm_impl: str = "auto", attn_impl: str = "auto",
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Fill caches from a prompt; returns (last-token logits, caches).
    ``prefix_embeds``: the VLM's patch embeddings (``_embed``)."""
    check_supported(cfg)
    b, s = tokens.shape
    x = _embed(params, tokens, ctx, prefix_embeds)
    positions = prompt_positions(b, s, tokens.device)
    new_caches = {}
    for g in layer_plan(cfg):
        x, nc = _scan_group(params[g.name], x, positions, cfg, g, ctx,
                            caches=caches[g.name], ssm_impl=ssm_impl,
                            attn_impl=attn_impl, return_state=True)
        new_caches[g.name] = nc
    x = L.rms_norm(params["final_ln"], x[:, -1:])
    return L.unembed(_head(params, cfg), x, ctx), new_caches


def decode_step(params: dict, token: torch.Tensor, index,
                cfg: ArchConfig, caches: dict,
                ctx: L.PhotonicCtx = L.EXACT_CTX,
                attn_impl: str = "auto") -> Tuple[torch.Tensor, dict]:
    """One decode step.  token: (B, 1) integer; index: its position, a
    Python int or a 0-d integer tensor on the token's device (what a CUDA
    graph of the step reads).  ``caches`` are updated in place and
    returned.  (One token: attention takes the grouped einsum whatever
    ``attn_impl`` says, as in the reference; the argument is checked and
    passed on.)"""
    check_supported(cfg)
    b = token.shape[0]
    x = L.embed(params["embed"], token)
    index, positions = step_positions(index, b, token.device)
    new_caches = {}
    for g in layer_plan(cfg):
        x, nc = _scan_group(params[g.name], x, positions, cfg, g, ctx,
                            caches=caches[g.name], cache_index=index,
                            attn_impl=attn_impl)
        new_caches[g.name] = nc
    x = L.rms_norm(params["final_ln"], x)
    return L.unembed(_head(params, cfg), x, ctx), new_caches
