"""Runnable training driver (counterpart of ``repro.launch.train``).

Trains any registered arch (``--smoke`` for the reduced config) on the
deterministic synthetic pipeline, with AdamW, checkpoint/restart,
straggler tracking, and optional photonic-numerics QAT (``--numerics
photonic_heana``), on the CUDA card unless ``--device cpu`` is given.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --steps 20 --batch 8 --seq 256
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --steps 50 --batch 8 --seq 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --smoke --steps 30 --numerics photonic_heana --device cpu

A step is ``model_zoo.loss_fn`` (remat on, as in the reference), then
``backward()``, then ``optim.optimizer.apply``.  Under grad the SSD scan
and attention take their plain, differentiable routes (the kernels are
forward-only, as the reference's Pallas kernels are); a photonic GEMM
runs the TAOM kernel on the card with a straight-through backward.  The
reference trains under ``PhotonicCtx(impl="ref")``, its jnp oracle; the
port's default ``impl="auto"`` runs the kernel, which is bit-equal to the
plain version (ROADMAP D7).  The params are leaf tensors that require
grad, updated in place by the optimizer.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import Backend, PhotonicConfig, resolve_device
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.models import model_zoo as zoo
from repro_torch.models.layers import PhotonicCtx
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim import optimizer as opt
from repro_torch.runtime.fault_tolerance import StragglerPolicy

NUMERICS = {
    "exact": None,
    "int8": PhotonicConfig(backend=Backend.INT_QUANT, bits=8,
                           noise_enabled=False),
    "photonic_heana": PhotonicConfig(backend=Backend.HEANA, bits=8,
                                     adc_bits=12, dpe_size=128,
                                     noise_enabled=False),
    "photonic_amw": PhotonicConfig(backend=Backend.AMW, bits=8, adc_bits=12,
                                   dpe_size=64, noise_enabled=False),
}


@dataclasses.dataclass
class TrainResult:
    steps: int
    first_loss: float
    final_loss: float
    tokens_per_s: float
    ckpt_dir: Optional[str]
    losses: List[float]          # every step's loss, in order
    step_s: List[float]          # every step's host time, loss read back
    params: dict                 # the trained params (leaf tensors)
    state: opt.AdamState         # the optimizer state after the last step


def device_batch(b: Dict[str, np.ndarray], cfg: ArchConfig,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """A pipeline batch on ``device``, with the audio family's zero
    frames and the VLM's zero patches in the model's dtype (the stubbed
    frontends' inputs, as in the reference)."""
    n = b["tokens"].shape[0]
    out = {k: torch.from_numpy(b[k]).to(device)
           for k in ("tokens", "targets")}
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "audio":
        out["frames"] = torch.zeros(
            (n, cfg.encoder_seq, zoo.WHISPER_FRAME_FEAT), dtype=dtype,
            device=device)
    if cfg.family == "vlm":
        out["patches"] = torch.zeros(
            (n, cfg.num_image_tokens, cfg.vision_embed_dim), dtype=dtype,
            device=device)
    return out


def train_step(params: dict, state: opt.AdamState,
               batch: Dict[str, torch.Tensor], cfg: ArchConfig,
               ctx: PhotonicCtx, adam: opt.AdamWConfig):
    """One step: loss, backward, AdamW.  Returns (loss (0-d, detached),
    new state, metrics); ``params`` are updated in place and keep this
    step's gradients in ``.grad``.  A param that the loss does not reach
    (v3's MTP head without ``mtp_weight``) gets a zero gradient, as
    ``jax.grad`` gives it, so weight decay still applies to it."""
    for _, p in tree_leaves(params):
        p.grad = None
    loss = zoo.loss_fn(params, batch, cfg, ctx)
    loss.backward()
    grads = tree_map(lambda p: torch.zeros_like(p) if p.grad is None
                     else p.grad, params)
    params, state, metrics = opt.apply(adam, params, state, grads)
    return loss.detach(), state, metrics


def train(arch: str, smoke: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 64, lr: float = 1e-3, numerics: str = "exact",
          ckpt_dir: Optional[str] = None, ckpt_every: int = 25,
          resume: bool = False, log_every: int = 10,
          seed: int = 0, total_steps: Optional[int] = None,
          impl: str = "auto", device=None) -> TrainResult:
    """``total_steps`` fixes the LR-schedule horizon independently of how
    many steps this invocation runs — required for exact resume semantics
    (a restarted run must see the same schedule).  ``impl``: the photonic
    GEMM's ('auto' | 'kernel' | 'ref', ``kernels.ops.photonic_matmul``).
    ``device``: the CUDA card unless named (``device="cpu"`` runs the
    plain PyTorch versions)."""
    device = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    horizon = total_steps or steps
    adam = opt.AdamWConfig(lr=lr, warmup_steps=max(2, horizon // 20),
                           total_steps=horizon)
    pcfg = NUMERICS[numerics]
    ctx = PhotonicCtx(cfg=pcfg, impl=impl) if pcfg else PhotonicCtx()

    params = zoo.init_params(cfg, seed, device)
    state = opt.init(params)
    start_step = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        (params, state), manifest = ckpt.restore(ckpt_dir, (params, state))
        start_step = manifest["step"]
        print(f"resumed from step {start_step}")
    params = tree_map(lambda p: p.requires_grad_(), params)

    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch, seed=seed)
    source = make_source(data_cfg)

    straggler = StragglerPolicy()
    losses: List[float] = []
    step_s: List[float] = []
    tokens_total = 0
    t0 = time.time()
    for step in range(start_step, steps):
        b = device_batch(source.batch(step), cfg, device)
        ts = time.time()
        loss, state, metrics = train_step(params, state, b, cfg, ctx, adam)
        loss = float(loss)              # waits for the whole step
        step_s.append(time.time() - ts)
        straggler.record("host0", step_s[-1])
        straggler.update_strikes()
        tokens_total += batch * seq
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, (params, state),
                      extra={"loss": loss})
            ckpt.retain(ckpt_dir, keep_last=3)
    dt = time.time() - t0
    return TrainResult(len(losses), losses[0] if losses else float("nan"),
                       losses[-1] if losses else float("nan"),
                       tokens_total / max(dt, 1e-9), ckpt_dir, losses,
                       step_s, params, state)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--numerics", default="exact", choices=list(NUMERICS))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args()
    res = train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                args.lr, args.numerics, args.ckpt_dir, resume=args.resume,
                device=args.device)
    print(f"done: loss {res.first_loss:.4f} -> {res.final_loss:.4f} "
          f"({res.tokens_per_s:.0f} tok/s)")


if __name__ == "__main__":
    main()
