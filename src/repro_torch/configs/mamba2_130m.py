"""mamba2-130m [ssm]: 24L d_model=768 (attn-free) vocab=50280,
ssm_state=128 — SSD [arXiv:2405.21060; unverified]."""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

FULL = ArchConfig(
    name="mamba2-130m", family="ssm", num_layers=24, d_model=768,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk=128))

SMOKE = ArchConfig(
    name="mamba2-130m", family="ssm", num_layers=2, d_model=64,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=512,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, n_groups=1,
                  conv_width=4, chunk=8))

register(FULL, SMOKE)
