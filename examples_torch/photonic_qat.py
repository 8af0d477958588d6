"""Beyond-paper feature: photonic-aware QAT (port).

Trains the same tiny LM twice — exact numerics vs *through* the HEANA
simulation (STE gradients, detection noise on) — then evaluates both under
HEANA inference numerics.  Both train under ``impl="auto"``: on the card
every photonic GEMM runs the TAOM kernel (4-bit, N = 83: its fused int8
route), which is the reference's ``impl="ref"`` oracle bit for bit
(ROADMAP D7).

Honest finding (the reference's): at smoke scale this is a NULL RESULT —
straight-through gradients make the two runs near-identical, so the
script demonstrates the *mechanism* (trainability through the photonic
simulation), not a measured QAT win.

  PYTHONPATH=src python examples_torch/photonic_qat.py [--steps N]
      [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.photonic_gemm import design_point
from repro_torch.core.types import Backend, resolve_device
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.launch.train import device_batch, train_step
from repro_torch.models import model_zoo as zoo
from repro_torch.models.layers import PhotonicCtx
from repro_torch.models.transformer import tree_map
from repro_torch.optim import optimizer as opt

STEPS, BATCH, SEQ = 200, 8, 64


def run(train_ctx: PhotonicCtx, eval_ctx: PhotonicCtx, steps: int,
        device, seed=0):
    """Train ``steps`` AdamW steps under ``train_ctx`` (each step's noise
    seeded 1000 + step), then the mean loss of 5 held-out batches under
    ``eval_ctx``.  Returns (last train loss, eval loss)."""
    cfg = get_config("qwen2-0.5b", smoke=True)
    adam = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps)
    params = tree_map(lambda p: p.requires_grad_(),
                      zoo.init_params(cfg, seed, device))
    state = opt.init(params)
    data = make_source(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                  global_batch=BATCH, seed=seed))
    loss = None
    for s in range(steps):
        ctx = (PhotonicCtx(cfg=train_ctx.cfg, seed=1000 + s,
                           impl=train_ctx.impl)
               if train_ctx.cfg else train_ctx)
        loss, state, _ = train_step(params, state,
                                    device_batch(data.batch(s), cfg, device),
                                    cfg, ctx, adam)
    # eval under photonic inference numerics
    eval_losses = []
    with torch.no_grad():
        for s in range(5):
            b = device_batch(data.batch(10_000 + s), cfg, device)
            eval_losses.append(float(zoo.loss_fn(params, b, cfg,
                                                 ctx=eval_ctx)))
    return float(loss), sum(eval_losses) / len(eval_losses)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    heana = design_point(Backend.HEANA, bits=4, data_rate_gsps=1.0,
                         adc_bits=8)
    eval_ctx = PhotonicCtx(cfg=heana, seed=9)
    print("training EXACT, evaluating on HEANA numerics...")
    tr_loss_e, ev_e = run(PhotonicCtx(), eval_ctx, args.steps, device)
    print(f"  train loss {tr_loss_e:.4f} -> HEANA eval loss {ev_e:.4f}")
    print("training THROUGH HEANA (QAT), evaluating on HEANA numerics...")
    tr_loss_q, ev_q = run(PhotonicCtx(cfg=heana), eval_ctx, args.steps,
                          device)
    print(f"  train loss {tr_loss_q:.4f} -> HEANA eval loss {ev_q:.4f}")
    gap = ev_e - ev_q
    print(f"\nQAT advantage on photonic hardware: {gap:+.4f} nats "
          f"({'QAT better' if gap > 0 else 'exact better'})")
    return {"exact": (tr_loss_e, ev_e), "qat": (tr_loss_q, ev_q),
            "gap": gap, "dpe_size": heana.dpe_size}


if __name__ == "__main__":
    main()
