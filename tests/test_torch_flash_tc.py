"""The numerics of the flash kernel's bf16 tensor-core design, rehearsed on
the CPU (``kernels/csrc/flash_attention.cu``, ``flash_attention_fwd_kernel_
tc``; the kernel itself runs only on the card, ``tests/test_torch_gpu.py``).

``_tc_emulation`` below computes what the kernel computes, in plain torch:
64-row query tiles and 64-key tiles with the kernel's tile skipping (no key
tile above the diagonal or wholly before the window), Q K^T over bf16
operands summed in float32 and scaled after the dot, the float32 online
softmax, and P V with P split into two bf16 terms, ``p_hi = bf16(p)`` and
``p_lo = bf16(p - p_hi)``, each multiplied by the bf16 V in float32.

Inputs are made from a seed with numpy.  Tolerances, as max |got - want|:
  * the split: |p - p_hi - p_lo| <= 2^-17 p.  p - p_hi is exact (Sterbenz)
    and at most half a bf16 ulp of p; rounding it to bf16 errs by at most
    half a bf16 ulp of the residual, 2^-17 p.  Below ~2^-117 the residual
    falls under bf16's smallest normal and its rounding errs by up to half
    the smallest subnormal, 2^-134, in absolute terms (the bound then is
    2^-17 p + 2^-134; such p scale a v by less than 1e-35);
  * against the plain version ``ops._flash_blocked`` (same bf16 inputs):
    one bf16 ulp of each query row's max|plain| binade, the check the card
    holds the kernel to.  Both keep P in float32 up to 2^-17 and round the
    output once; float32 sums in other orders (64-key tiles against
    128-key blocks) can move that rounding by one ulp of the element, at
    most one of its row's max binade (a row bound, not a global one: a
    late causal row averages many values and is small, and a global bound
    would let a wrong normalization there pass);
  * against the reference's Pallas kernel in interpret mode: 2^-7 *
    max|ref|, ``BF16_UNIT`` of tests/test_torch_attention.py, for the
    reason its docstring gives (XLA's float32 sums run in other orders
    than torch's, which can move a bf16 rounding by one ulp of max's
    binade, up to 2^-7 * max|ref|).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jflash
from repro_torch.kernels import ops

TILE = 64
NEG_INF = -1.0e30
SPLIT_REL = 2.0 ** -17
BF16_SUBNORMAL_HALF = 2.0 ** -134
BF16_UNIT = 2.0 ** -7


def _split(p: torch.Tensor):
    """The kernel's two-term split of a float32 P (round to nearest even,
    as ``__float2bfloat16_rn``)."""
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    return hi, lo


def _tc_emulation(q, k, v, causal=True, window=0, skip=True):
    """The bf16 kernel's algorithm in torch: q, k, v (BH, S, D) bf16 ->
    (BH, S, D) bf16.  ``skip=False`` visits every key tile, as the TPU
    kernel does."""
    bh, s, d = q.shape
    scale = d ** -0.5
    sp = -(-s // TILE) * TILE
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 0, 0, sp - s))
    qf, kf, vf = pad(q), pad(k), pad(v)
    out = torch.empty((bh, sp, d), dtype=torch.float32)
    for q0 in range(0, sp, TILE):
        qi = torch.arange(q0, q0 + TILE)[:, None]
        last_row = min(q0 + TILE, s) - 1
        k_end = last_row + 1 if causal else s
        k_first = max(0, q0 - window + 1) // TILE if window else 0
        tiles = (range(k_first * TILE, k_end, TILE) if skip
                 else range(0, sp, TILE))
        m = torch.full((bh, TILE, 1), NEG_INF)
        l = torch.zeros((bh, TILE, 1))
        acc = torch.zeros((bh, TILE, d))
        for k0 in tiles:
            sc = torch.matmul(qf[:, q0:q0 + TILE],
                              kf[:, k0:k0 + TILE].transpose(1, 2))
            kj = torch.arange(k0, k0 + TILE)[None, :]
            valid = kj < s
            if causal:
                valid = valid & (kj <= qi)
            if window:
                valid = valid & (kj > qi - window)
            sc = torch.where(valid, sc * scale, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            p = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            hi, lo = _split(p)
            vt = vf[:, k0:k0 + TILE]
            acc = acc * corr + torch.matmul(hi, vt)
            acc = acc + torch.matmul(lo, vt)
            m = m_new
        out[:, q0:q0 + TILE] = acc / torch.clamp_min(l, 1e-30)
    return out[:, :s].to(torch.bfloat16)


def _qkv(bh, s, d, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((bh, s, d)).astype(np.float32)
            for _ in range(3)]
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    tx = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    return jx, tx


def _split_values(which: str) -> torch.Tensor:
    rng = np.random.default_rng(17)
    if which == "special":
        pows = [2.0 ** -e for e in range(0, 127)]
        near = math.exp(-87.0)
        vals = ([0.0, 1.0] + pows +
                [near * f for f in (0.5, 0.9, 1.0, 1.1, 2.0, 3.7)] +
                [1.0 - 2.0 ** -24, 1.0 - 2.0 ** -9, 2.0 ** -8 * 3])
        return torch.tensor(vals, dtype=torch.float32)
    if which == "uniform":
        return torch.from_numpy(rng.random(200_000).astype(np.float32))
    # exp of a softmax's shifted scores, s - m in [-88, 0]
    return torch.from_numpy(np.exp(-rng.random(200_000) * 88.0)
                            .astype(np.float32))


@pytest.mark.parametrize("which", ["special", "uniform", "exp"])
def test_two_term_split_keeps_p_to_2_to_the_minus_17(which):
    p = _split_values(which)
    assert bool(((p >= 0) & (p <= 1)).all())
    hi, lo = _split(p)
    # both terms are bf16 values, and the residual is exact in float32
    assert torch.equal(hi, hi.to(torch.bfloat16).float())
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    err = (p.double() - hi.double() - lo.double()).abs()
    bound = SPLIT_REL * p.double() + BF16_SUBNORMAL_HALF
    assert bool((err <= bound).all()), float((err - bound).max())
    normal = p >= 2.0 ** -117
    assert bool((err[normal] <= SPLIT_REL * p.double()[normal]).all())
    assert torch.equal(hi[p == 0], p[p == 0]) and bool((lo[p == 0] == 0).all())
    one = p == 1.0
    assert bool((hi[one] == 1.0).all()) and bool((lo[one] == 0.0).all())


@pytest.mark.parametrize("d", [16, 24, 64, 120])
@pytest.mark.parametrize("s", [1, 37, 130])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 32])
def test_tc_emulation_matches_plain_and_pallas_bf16(d, s, causal, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, s, d, 1000 * d + 10 * s + window)
    got = _tc_emulation(tq, tk, tv, causal, window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    assert bool(torch.isfinite(got.float()).all())
    # the skipped tiles change nothing, bit for bit
    assert torch.equal(got, _tc_emulation(tq, tk, tv, causal, window,
                                          skip=False))

    plain = ops._flash_blocked(tq, tk, tv, causal, window).float()
    err = (got.float() - plain).abs().amax(-1)
    row_max = plain.abs().amax(-1).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(row_max)) - 7)
    assert bool((err <= ulp).all()), float((err / ulp).max())

    want = np.asarray(jflash(jq, jk, jv, causal=causal, window=window,
                             interpret=True).astype(jnp.float32))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= BF16_UNIT * float(np.abs(want).max()), err
