"""whisper-tiny [audio]: 4L d_model=384 6H d_ff=1536 vocab=51865 —
enc-dec, conv frontend STUB [arXiv:2212.04356; unverified]."""
from repro_torch.configs.base import ArchConfig, register

FULL = ArchConfig(
    name="whisper-tiny", family="audio", num_layers=4, d_model=384,
    num_heads=6, num_kv_heads=6, d_ff=1536, vocab_size=51865,
    head_dim=64, encoder_layers=4, encoder_seq=1500, head_pad=16)

SMOKE = ArchConfig(
    name="whisper-tiny", family="audio", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
    head_dim=16, encoder_layers=2, encoder_seq=24)

register(FULL, SMOKE)
