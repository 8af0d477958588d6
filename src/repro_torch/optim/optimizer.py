"""AdamW + schedules on param trees (counterpart of
``repro.optim.optimizer``).

The optimizer state mirrors the params: float32 moments ``m`` and ``v`` in
nested dicts of the params' structure, and a 0-d int32 ``step``.  ``apply``
is the reference's update, op for op: the gradients' global norm, the
clip factor ``min(1, grad_clip / (norm + 1e-9))``, bias-corrected moments,
decoupled weight decay inside the step, every leaf's arithmetic in
float32 and the result cast back to the param's dtype.  (``torch.optim.
AdamW`` is a different function: it does a bf16 param's arithmetic in
bf16 and decays before the step.)

The params are leaf tensors that require grad: ``apply`` writes the new
values into them in place (under ``torch.no_grad``), so they stay the
leaves that the next backward fills; it returns them with a new state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.models.transformer import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: dict                 # float32, like params
    v: dict                 # float32, like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (float32)."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def init(params) -> AdamState:
    """Zero moments (float32) and step 0, on the params' device."""
    leaves = [p for _, p in tree_leaves(params)]
    device = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda: tree_map(                              # noqa: E731
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params)
    return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                     zeros(), zeros())


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sums = [torch.sum(torch.square(g.to(torch.float32)))
            for _, g in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sums).sum())


@torch.no_grad()
def apply(cfg: AdamWConfig, params, state: AdamState, grads,
          lr_scale: float = 1.0):
    """One AdamW update.  Returns (params, new_state, metrics); the params
    are the same leaf tensors, updated in place."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step) * lr_scale
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, stepf)
    b2c = 1 - torch.pow(cfg.b2, stepf)

    ps = [p for _, p in tree_leaves(params)]
    gs = [g.to(torch.float32) * clip for _, g in tree_leaves(grads)]
    ms = [m for _, m in tree_leaves(state.m)]
    vs = [v for _, v in tree_leaves(state.v)]
    # m2 = b1 m + (1 - b1) g;  v2 = b2 v + ((1 - b2) g) g, rounded in the
    # reference's order
    m2 = torch._foreach_add(torch._foreach_mul(ms, cfg.b1),
                            torch._foreach_mul(gs, 1 - cfg.b1))
    v2 = torch._foreach_add(torch._foreach_mul(vs, cfg.b2), torch._foreach_mul(
        torch._foreach_mul(gs, 1 - cfg.b2), gs))
    # delta = (m2 / b1c) / (sqrt(v2 / b2c) + eps) + wd p
    mhat = torch._foreach_div(m2, b1c)
    denom = torch._foreach_add(torch._foreach_sqrt(
        torch._foreach_div(v2, b2c)), cfg.eps)
    pf = [p.to(torch.float32) for p in ps]
    delta = torch._foreach_add(torch._foreach_div(mhat, denom),
                               torch._foreach_mul(pf, cfg.weight_decay))
    p2 = torch._foreach_sub(pf, torch._foreach_mul(delta, lr))
    for p, new in zip(ps, p2):
        p.copy_(new)                    # cast back to the param's dtype

    new_state = AdamState(step, _rebuild(state.m, m2), _rebuild(state.v, v2))
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


def _rebuild(like: dict, flat: list) -> dict:
    """``like``'s nested dicts with their leaves, in ``tree_leaves``
    order (sorted keys), replaced by ``flat``."""
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        return next(it)
    return go(like)
