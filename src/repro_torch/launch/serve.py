"""Serving entry point: batched prefill + decode with caches (counterpart of
``repro.launch.serve``).

Builds a request batch of seeded random prompts, prefills, then decodes N
tokens per request (greedy, or sampled at a temperature).  Runs on the
CUDA card unless ``device`` names another device.

On the card the decode step runs as one CUDA graph (``DecodeGraph``), the
port's counterpart of the reference's ``jax.jit`` of the step: after the
prefill the state is copied into static buffers, one step is captured
over them (token in, position in, logits out) and replayed ``gen - 1``
times; the token pick (argmax, or a multinomial draw with the sampler)
stays outside the graph.  The capture happens before the decode clock
starts and is timed on its own (``capture_s``); the reference's
``decode_s`` includes its jit compile (ROADMAP D4).  A capture or replay
that fails raises.  On the CPU the step runs eagerly.

Which kernels the prefill drives: for the ssm family (mamba2) the SSD scan
through ``ssm_impl``, for the dense family (qwen2, h2o-danube3, gemma3)
each attention layer's self-attention over the prompt through
``attn_impl`` — the flash kernel (``kernels/flash_attention.py``).  Both
default to 'auto': the Hopper kernel on the card, the plain version on the
CPU.  The reference's ``serve()`` leaves both at their jnp/XLA defaults,
and no reference entry point reaches its Pallas flash kernel (only
``attention(attn_impl="pallas")`` does); the port drives its kernel from
the prefill because the prefill into an empty cache computes the same
function as that cache-less branch, which the reference describes as the
train/prefill hot path.  Decode takes no kernel: the SSD one-token
recurrence and the grouped-einsum attention over the KV cache, as in the
reference.  Each impl computes one function (the tests hold them
together).  The graph replays the same kernels the eager step launches.

``tokens_per_s`` is the decode rate: the ``gen - 1`` tokens per request
that decode steps make, over the decode time (the first token comes from
the prefill; the reference counts ``gen``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --smoke --batch 4 --prompt-len 32 --gen 16 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import cuda_graph
from repro_torch.core.photonic_gemm import fold_seed
from repro_torch.core.types import resolve_device
from repro_torch.models import model_zoo as zoo
from repro_torch.models.transformer import tree_map


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, prompt+gen), int64, on the CPU
    prefill_s: float
    decode_s: float
    tokens_per_s: float           # decode steps' tokens / decode_s
    capture_s: float = 0.0        # the decode step's capture (CUDA only)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DecodeGraph:
    """One decode step of ``cfg`` captured in a CUDA graph over static
    buffers: ``step(token, index)`` -> (B, 1, vocab) logits.

    ``state`` (a prefill's or a decode step's) is copied into the graph's
    static state, which each replay advances in place; ``token`` (B, 1)
    gives the token buffer's shape and dtype.  ``core.cuda_graph.capture``
    captures the step, after an eager warm step over a throwaway copy of
    the state; the graph has its own memory pool, and the allocator's
    cache stays warm for the eager work after it.  The logits returned
    are the graph's static output: read them before the next call.
    """

    def __init__(self, params, cfg, state, token: torch.Tensor,
                 attn_impl: str = "auto") -> None:
        dev = token.device
        if dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, the token "
                             f"is on {dev}")
        self.state = tree_map(torch.clone, state)
        self.token = token.clone()
        self.index = torch.zeros((), dtype=torch.int64, device=dev)
        self.graph, (self.logits, _) = cuda_graph.capture(
            lambda: zoo.decode_fn(params, self.token, self.index, cfg,
                                  self.state, attn_impl=attn_impl),
            dev,
            warm=lambda: zoo.decode_fn(params, self.token, self.index, cfg,
                                       tree_map(torch.clone, state),
                                       attn_impl=attn_impl))

    def __call__(self, token: torch.Tensor, index: int) -> torch.Tensor:
        self.token.copy_(token)
        self.index.fill_(int(index))
        self.graph.replay()
        return self.logits


def serve(arch: str, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, seed: int = 0,
          greedy: bool = True, temperature: float = 1.0,
          ssm_impl: str = "auto", attn_impl: str = "auto",
          device=None) -> ServeResult:
    if gen < 1 or prompt_len < 1 or batch < 1:
        raise ValueError("batch, prompt_len and gen must be >= 1")
    device = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    params = zoo.init_params(cfg, seed, device)
    max_len = prompt_len + gen
    caches = zoo.init_caches(cfg, batch, max_len, getattr(torch, cfg.dtype),
                             device)
    prompts = torch.randint(
        0, cfg.vocab_size, (batch, prompt_len),
        generator=torch.Generator().manual_seed(fold_seed(seed, 1)))
    sampler = None
    if not greedy:
        sampler = torch.Generator(device=device)
        sampler.manual_seed(fold_seed(seed, 100))

    _sync(device)
    t0 = time.perf_counter()
    logits, state = zoo.prefill_fn(params, {"tokens": prompts.to(device)},
                                   cfg, caches, ssm_impl=ssm_impl,
                                   attn_impl=attn_impl)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    def pick(logits: torch.Tensor) -> torch.Tensor:
        last = logits[:, -1].to(torch.float32)
        if greedy:
            return torch.argmax(last, -1)[:, None]
        probs = torch.softmax(last / temperature, -1)
        return torch.multinomial(probs, 1, generator=sampler)

    tok = pick(logits)
    out = [tok]
    step, t_capture = None, 0.0
    if device.type == "cuda" and gen > 1:
        t0 = time.perf_counter()
        step = DecodeGraph(params, cfg, state, tok, attn_impl)
        del state                   # the graph holds its own copy
        _sync(device)
        t_capture = time.perf_counter() - t0
    t1 = time.perf_counter()
    for i in range(gen - 1):
        if step is not None:
            logits = step(tok, prompt_len + i)
        else:
            logits, state = zoo.decode_fn(params, tok, prompt_len + i, cfg,
                                          state, attn_impl=attn_impl)
        tok = pick(logits)
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t1
    seq = torch.cat([prompts] + [t.cpu() for t in out], dim=1)
    return ServeResult(seq, t_prefill, t_decode,
                       batch * (gen - 1) / max(t_decode, 1e-9), t_capture)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--ssm-impl", default="auto")
    ap.add_argument("--attn-impl", default="auto",
                    choices=("auto", "kernel", "ref", "dense"))
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    r = serve(args.arch, args.smoke, args.batch, args.prompt_len, args.gen,
              ssm_impl=args.ssm_impl, attn_impl=args.attn_impl,
              device=args.device)
    print(f"prefill {r.prefill_s*1e3:.1f} ms, decode {r.decode_s*1e3:.1f} ms"
          f" ({r.tokens_per_s:.1f} tok/s), decode-step capture "
          f"{r.capture_s*1e3:.1f} ms, output shape {tuple(r.tokens.shape)}")


if __name__ == "__main__":
    main()
