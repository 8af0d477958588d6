"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global, 128k [hf:google/gemma-3-1b-pt;
unverified].  Period-6 superblocks (5 x window-1024 local + 1 global);
long_500k runs (local layers windowed, global layers full cache)."""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="gemma3-12b", family="dense", num_layers=48, d_model=3840,
    num_heads=16, num_kv_heads=8, d_ff=15360, vocab_size=262144,
    head_dim=240, rope_theta=1e6, local_global_period=6, local_window=1024)

SMOKE = ArchConfig(
    name="gemma3-12b", family="dense", num_layers=6, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
    head_dim=16, rope_theta=1e6, local_global_period=6, local_window=8)

register(FULL, SMOKE)
