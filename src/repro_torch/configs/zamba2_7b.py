"""zamba2-7b [hybrid]: 81L d_model=3584 32H (shared attn) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 + shared attention blocks
[arXiv:2411.15242; unverified].  One shared attention block (shared
params, per-position KV cache) every 6 mamba blocks."""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

FULL = ArchConfig(
    name="zamba2-7b", family="hybrid", num_layers=81, d_model=3584,
    num_heads=32, num_kv_heads=32, d_ff=14336, vocab_size=32000,
    head_dim=112, shared_attn_period=6,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk=128))

SMOKE = ArchConfig(
    name="zamba2-7b", family="hybrid", num_layers=7, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
    head_dim=16, shared_attn_period=3,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, n_groups=1,
                  conv_width=4, chunk=8))

register(FULL, SMOKE)
