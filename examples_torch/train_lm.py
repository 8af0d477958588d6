"""End-to-end driver: train a ~100M-param LM for a few hundred steps on
the synthetic pipeline, with checkpoint/restart (port).

Defaults train mamba2-130m (the smallest full config, ~168M params with
embeddings) for 200 steps at seq 256 on the card.  Pass --smoke to use
the reduced config for a fast sanity run, or lower --steps.  A run finds
the latest checkpoint in --ckpt-dir and resumes from it.

  PYTHONPATH=src python examples_torch/train_lm.py --steps 200
  PYTHONPATH=src python examples_torch/train_lm.py --smoke --steps 50 \\
      --device cpu
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import train


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    res = train(arch=args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=3e-4,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                resume=True, device=args.device)
    print(f"\nloss {res.first_loss:.3f} -> {res.final_loss:.3f} over "
          f"{res.steps} steps ({res.tokens_per_s:.0f} tok/s); "
          f"checkpoints in {res.ckpt_dir}")
    assert res.final_loss < res.first_loss, "training must reduce loss"
    return {"steps": res.steps, "first_loss": res.first_loss,
            "final_loss": res.final_loss, "losses": res.losses,
            "step_s": res.step_s, "tokens_per_s": res.tokens_per_s,
            "ckpt_dir": res.ckpt_dir}


if __name__ == "__main__":
    main()
