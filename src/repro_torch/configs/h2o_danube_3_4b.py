"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix, SWA [arXiv:2401.16818; unverified].
Sliding window 4096 (mistral-style) -> long_500k cell runs with a
windowed cache."""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="h2o-danube-3-4b", family="dense", num_layers=24, d_model=3840,
    num_heads=32, num_kv_heads=8, d_ff=10240, vocab_size=32000,
    head_dim=120, rope_theta=1e4, sliding_window=4096)

SMOKE = ArchConfig(
    name="h2o-danube-3-4b", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=160, vocab_size=512,
    head_dim=16, rope_theta=1e4, sliding_window=16)

register(FULL, SMOKE)
