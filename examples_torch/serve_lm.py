"""Serving example: batched prefill + greedy decode on any arch (port).

On the card the prefill runs the port's kernels (the SSD scan, flash
attention) and the decode step replays as a CUDA graph.

  PYTHONPATH=src python examples_torch/serve_lm.py --arch zamba2-7b --smoke
  PYTHONPATH=src python examples_torch/serve_lm.py --arch qwen2-0.5b --full
  PYTHONPATH=src python examples_torch/serve_lm.py --device cpu
"""
import argparse

from repro_torch.launch.serve import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args(argv)
    r = serve(args.arch, args.smoke, args.batch, args.prompt_len, args.gen,
              device=args.device)
    print(f"arch={args.arch} prefill={r.prefill_s*1e3:.1f}ms "
          f"decode={r.decode_s*1e3:.1f}ms throughput={r.tokens_per_s:.1f} "
          f"tok/s")
    print("first sequence:", r.tokens[0].tolist())
    return {"arch": args.arch, "smoke": args.smoke,
            "prefill_s": r.prefill_s, "decode_s": r.decode_s,
            "capture_s": r.capture_s, "tokens_per_s": r.tokens_per_s,
            "tokens": r.tokens}


if __name__ == "__main__":
    main()
