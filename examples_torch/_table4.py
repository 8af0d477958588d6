"""The Table-4 accuracy proxy's data, training and evaluation, on the port.

The port's copies of ``make_data``, ``train_model`` and ``evaluate`` from
the reference's ``benchmarks/table4_accuracy.py`` (its benchmark harness,
``run``, is not ported): a small CNN is trained (exact numerics, float32)
on a synthetic 10-class image task, then evaluated with its conv/fc GEMMs
executed as

    exact | int8 quantized | HEANA (8-bit, analog carry + noise) |
    MAW (8-bit, per-chunk ADC + noise)

The data and the initial weights come from torch generators on the CPU
(the same values on every device), not from ``jax.random``, so the port's
top-1 numbers are its own; the tests carry the reference's data and
params across instead.  ``evaluate`` runs ``ops.photonic_matmul`` under
``impl="auto"``: the TAOM kernel on the card (the reference uses its jnp
oracle, ``impl="ref"``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core.photonic_gemm import (design_point, fold_seed,
                                            generator_for)
from repro_torch.core.types import Backend, PhotonicConfig, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.cnn import build_small_cnn, small_cnn_apply

HW, NCLASS = 16, 10
NUMERICS = ("exact", "int8", "heana", "maw")
TEMPLATE_SEED = 42
NOISE_SEED = 7


def templates() -> torch.Tensor:
    """The ten FIXED class templates, (NCLASS, HW, HW, 3)."""
    return torch.randn((NCLASS, HW, HW, 3),
                       generator=torch.Generator().manual_seed(TEMPLATE_SEED))


def make_data(n: int, seed: int, noise: float = 2.5,
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """FIXED class templates + Gaussian noise: a learnable 10-way task.
    Drawn on the CPU from ``seed`` (labels, then noise), then moved to
    ``device``."""
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, NCLASS, (n,), generator=gen)
    x = templates()[labels] + noise * torch.randn((n, HW, HW, 3),
                                                  generator=gen)
    device = resolve_device(device)
    return x.to(device), labels.to(device)


def sgd_step(params: dict, x: torch.Tensor, y: torch.Tensor,
             lr: float) -> Tuple[dict, torch.Tensor]:
    """One step of ``train_model``: the mean cross-entropy of the exact
    forward, its gradient, ``p - lr * g``.  Returns (new params, loss)."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    logits = small_cnn_apply(leaves, x)
    loss = -torch.mean(torch.gather(torch.log_softmax(logits, -1), 1,
                                    y.long()[:, None]))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    with torch.no_grad():
        new = {k: p - lr * g for (k, p), g in zip(leaves.items(), grads)}
    return new, loss.detach()


def train_model(steps: int = 150, lr: float = 0.05, batch: int = 64,
                seed: int = 0, device=None) -> Tuple[dict, List[float]]:
    """Plain SGD on the exact forward.  Returns (params, every step's
    loss)."""
    device = resolve_device(device)
    params = build_small_cnn(torch.Generator().manual_seed(fold_seed(seed, 1)),
                             NCLASS, HW, device=device)
    losses = []
    for s in range(steps):
        x, y = make_data(batch, fold_seed(seed, 1000 + s), device=device)
        params, loss = sgd_step(params, x, y, lr)
        losses.append(loss)
    return params, [float(v) for v in losses]


def numerics_config(numerics: str) -> Optional[PhotonicConfig]:
    """The PhotonicConfig of one Table-4 column (None: exact)."""
    if numerics == "exact":
        return None
    if numerics == "int8":
        return PhotonicConfig(backend=Backend.INT_QUANT, bits=8,
                              noise_enabled=False)
    if numerics == "heana":
        return design_point(Backend.HEANA, 8, 1.0, adc_bits=12)
    if numerics == "maw":
        return design_point(Backend.MAW, 8, 1.0, adc_bits=12)
    raise ValueError(f"numerics must be one of {NUMERICS}, got {numerics!r}")


def gemm_under(numerics: str, impl: str = "auto"):
    """The matmul ``logits_under`` runs every GEMM through under
    ``numerics`` (None: exact).

    Every GEMM draws its detection noise from a FRESH generator seeded
    with ``NOISE_SEED`` on its input's device, as the reference passes one
    ``PRNGKey(7)`` to every GEMM (not one generator that advances)."""
    cfg = numerics_config(numerics)
    if cfg is None:
        return None

    def mm(a, w):
        return ops.photonic_matmul(a, w, cfg,
                                   generator=generator_for(NOISE_SEED,
                                                           a.device),
                                   impl=impl)

    return mm


def logits_under(params: dict, x: torch.Tensor, numerics: str,
                 impl: str = "auto") -> torch.Tensor:
    """The small CNN's logits with every GEMM run under ``numerics``
    (``gemm_under``)."""
    return small_cnn_apply(params, x, matmul=gemm_under(numerics, impl))


def evaluate(params: dict, numerics: str, n: int = 512, seed: int = 123,
             impl: str = "auto") -> float:
    """Top-1 accuracy on ``n`` held-out images under ``numerics``."""
    device = next(iter(params.values())).device
    x, y = make_data(n, seed, device=device)
    with torch.no_grad():
        logits = logits_under(params, x, numerics, impl)
    return float(torch.mean((torch.argmax(logits, -1) == y).float()))
