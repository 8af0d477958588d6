"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280, MoE 256e top-8 — MLA, 1 shared + 256 routed, MTP
[arXiv:2412.19437; hf].  First 3 layers dense (d_ff 18432)."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

FULL = ArchConfig(
    name="deepseek-v3-671b", family="moe", num_layers=61, d_model=7168,
    num_heads=128, num_kv_heads=128, d_ff=18432, vocab_size=129280,
    rope_theta=1e4,
    moe=MoEConfig(num_experts=256, experts_per_token=8,
                  num_shared_experts=1, d_ff_expert=2048,
                  first_dense_layers=3),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_rope_dim=64,
                  qk_nope_dim=128, v_head_dim=128),
    mtp_depth=1)

SMOKE = ArchConfig(
    name="deepseek-v3-671b", family="moe", num_layers=4, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=192, vocab_size=512,
    rope_theta=1e4,
    moe=MoEConfig(num_experts=8, experts_per_token=2,
                  num_shared_experts=1, d_ff_expert=32,
                  first_dense_layers=2),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_rope_dim=16,
                  qk_nope_dim=32, v_head_dim=32),
    mtp_depth=1)

register(FULL, SMOKE)
