"""Base layers: parameter construction, photonic-routable dense, norms, RoPE
(counterpart of ``repro.models.layers``).

Parameters are plain nested dicts of tensors.  ``ParamMaker`` draws each
one from its own ``torch.Generator``, seeded with ``fold_seed(seed,
crc32(name))`` in place of the reference's ``jax.random.fold_in``, so a
parameter's values depend only on the seed and its name — not on the
order of construction or on the device.  A parameter with a leading
expert axis (``EXPERT``) draws expert ``e`` from ``fold_seed`` of that
seed and ``e``, the experts on threads.  Draws are made on the CPU and
moved to ``device``.  On the ``meta`` device nothing is drawn: the tree
holds its shapes and dtypes only (the reference's abstract mode).
``ParamMaker(None)`` is the reference's spec mode: each ``param`` returns
its tuple of logical axes, so one code path builds the params and their
spec tree (``parallel/sharding.py`` maps the axes to a mesh).

``dense`` is the paper integration point: every projection in the zoo goes
through it, and an active ``PhotonicCtx`` reroutes the matmul through the
HEANA / AMW / MAW numerics (``kernels.ops.photonic_matmul``).
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.photonic_gemm import fold_seed, generator_for
from repro_torch.core.types import Backend, PhotonicConfig

# Logical axis names (parallel/sharding.RULES maps them to mesh axes).
EMBED = "embed"
MLP = "mlp"
HEADS = "heads"
KV_HEADS = "kv_heads"
VOCAB = "vocab"
SSM_INNER = "ssm_inner"
EXPERT = "expert"
STACK = "stack"      # a stacked group's leading layer axis
NONE = None


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * (1 / (1 + exp(-x))), one op at a time in x's dtype — the
    reference's ``jax.nn.silu``, rounding for rounding (in bfloat16
    ``torch.nn.functional.silu`` rounds once and differs in ~1/3 of the
    entries by an ulp)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU, the reference's ``jax.nn.gelu``
    (approximate=True by default; PyTorch's default is the erf form):
    0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), one op at a time in
    x's dtype with the constants rounded to it, as the reference rounds
    (``torch.nn.functional.gelu(approximate="tanh")`` rounds once, and in
    bfloat16 differs from the reference by an ulp in ~40% of entries)."""
    c = float(torch.tensor(0.7978845608028654, dtype=x.dtype))
    k = float(torch.tensor(0.044715, dtype=x.dtype))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def name_seed(seed: int, name: str) -> int:
    """The seed of the stream a named parameter or call site draws from."""
    return fold_seed(seed, zlib.crc32(name.encode()))


class ParamMaker:
    """Builds seeded param tensors of ``dtype`` on ``device``, or (seed
    None) each param's tuple of logical axes."""

    def __init__(self, seed: Optional[int],
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device = torch.device("cpu")):
        self.seed = None if seed is None else int(seed)
        self.dtype = dtype
        self.device = device

    @property
    def spec_mode(self) -> bool:
        return self.seed is None

    def param(self, name: str, shape: Sequence[int], axes: Tuple,
              init: str = "normal", scale: Optional[float] = None):
        assert len(axes) == len(shape), (name, shape, axes)
        if self.spec_mode:
            return axes
        shape = tuple(shape)
        if self.device.type == "meta" or init == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
        if init == "embed":
            fan_in = 1.0
        s = scale if scale is not None else fan_in ** -0.5
        seed = name_seed(self.seed, name)
        if axes[0] != EXPERT:
            return _draw(seed, shape, s, self.dtype).to(self.device)
        # One stream an expert, the experts on threads (a deepseek-v2 MoE
        # layer holds 3.8 G routed-expert weights).
        w = torch.empty(shape, dtype=self.dtype)

        def expert(e: int) -> None:
            w[e] = _draw(fold_seed(seed, e), shape[1:], s, self.dtype)
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            list(pool.map(expert, range(shape[0])))
        return w.to(self.device)


def _draw(seed: int, shape: Tuple[int, ...], scale: float,
          dtype: torch.dtype) -> torch.Tensor:
    """N(0, scale^2) from stream ``seed``, drawn in float32 on the CPU,
    then rounded to ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * scale).to(dtype)


@dataclasses.dataclass(frozen=True)
class PhotonicCtx:
    """Routes zoo matmuls through the photonic numerics simulation.

    cfg=None or backend=EXACT -> plain matmul.  ``seed`` enables the
    detection-noise draw; each call site folds in its name so layers get
    independent noise.  ``impl`` is ``photonic_matmul``'s: 'auto' (the
    Hopper kernel for CUDA tensors, the plain version for CPU tensors),
    'kernel' or 'ref'.  (The reference defaults to its jnp oracle, 'ref';
    the port's default, 'auto', is the same function on the CPU.)
    """
    cfg: Optional[PhotonicConfig] = None
    seed: Optional[int] = None
    impl: str = "auto"

    @property
    def active(self) -> bool:
        return self.cfg is not None and self.cfg.backend != Backend.EXACT

    def site_seed(self, name: str) -> Optional[int]:
        if self.seed is None:
            return None
        return name_seed(self.seed, name)


EXACT_CTX = PhotonicCtx()


def dense(params, x: torch.Tensor, ctx: PhotonicCtx = EXACT_CTX,
          name: str = "dense") -> torch.Tensor:
    """(..., K) @ w[K, D] (+ b) — photonic-routable."""
    w = params["w"]
    if ctx.active:
        from repro_torch.kernels import ops as kops
        seed = ctx.site_seed(name)
        gen = None if seed is None else generator_for(seed, x.device)
        out = kops.photonic_matmul(x, w, ctx.cfg, generator=gen,
                                   impl=ctx.impl)
    else:
        out = x @ w
    if "b" in params:
        out = out + params["b"]
    return out


def make_dense(maker: ParamMaker, name: str, d_in: int, d_out: int,
               axes: Tuple = (EMBED, MLP), bias: bool = False,
               scale: Optional[float] = None) -> dict:
    p = {"w": maker.param(f"{name}.w", (d_in, d_out), axes, scale=scale)}
    if bias:
        p["b"] = maker.param(f"{name}.b", (d_out,), (axes[1],), init="zeros")
    return p


def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def make_rms_norm(maker: ParamMaker, name: str, dim: int) -> torch.Tensor:
    return maker.param(f"{name}.scale", (dim,), (EMBED,), init="zeros")


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["g"].to(torch.float32) +
            params["b"].to(torch.float32)).to(dt)


def make_layer_norm(maker: ParamMaker, name: str, dim: int) -> dict:
    return {"g": maker.param(f"{name}.g", (dim,), (EMBED,), init="ones"),
            "b": maker.param(f"{name}.b", (dim,), (EMBED,), init="zeros")}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (...,S,hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings / heads
# ---------------------------------------------------------------------------
def make_embedding(maker: ParamMaker, name: str, vocab: int,
                   dim: int) -> dict:
    # GPT-style 0.02 init keeps tied-head logits near zero at init.
    return {"table": maker.param(f"{name}.table", (vocab, dim),
                                 (VOCAB, EMBED), init="embed", scale=0.02)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params, x: torch.Tensor, ctx: PhotonicCtx = EXACT_CTX
            ) -> torch.Tensor:
    """Logits projection.  Kept in exact numerics even under a photonic
    ctx (the paper quantizes conv/GEMM compute; classifier heads stay
    digital)."""
    del ctx
    return x @ params["table"].T


def make_mlp(maker: ParamMaker, name: str, d_model: int, d_ff: int,
             gated: bool = True) -> dict:
    p = {"up": make_dense(maker, f"{name}.up", d_model, d_ff, (EMBED, MLP)),
         "down": make_dense(maker, f"{name}.down", d_ff, d_model,
                            (MLP, EMBED))}
    if gated:
        p["gate"] = make_dense(maker, f"{name}.gate", d_model, d_ff,
                               (EMBED, MLP))
    return p


def mlp(params, x: torch.Tensor, ctx: PhotonicCtx = EXACT_CTX,
        name: str = "mlp", act=silu) -> torch.Tensor:
    up = dense(params["up"], x, ctx, f"{name}.up")
    if "gate" in params:
        gate = dense(params["gate"], x, ctx, f"{name}.gate")
        h = act(gate) * up
    else:
        h = act(up)
    return dense(params["down"], h, ctx, f"{name}.down")
