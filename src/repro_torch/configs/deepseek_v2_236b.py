"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MoE 160e top-6 — MLA kv_lora=512, 2 shared + 160 routed
[arXiv:2405.04434; hf].  First layer dense (d_ff 12288)."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

FULL = ArchConfig(
    name="deepseek-v2-236b", family="moe", num_layers=60, d_model=5120,
    num_heads=128, num_kv_heads=128, d_ff=12288, vocab_size=102400,
    rope_theta=1e4,
    moe=MoEConfig(num_experts=160, experts_per_token=6,
                  num_shared_experts=2, d_ff_expert=1536,
                  first_dense_layers=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_rope_dim=64,
                  qk_nope_dim=128, v_head_dim=128))

SMOKE = ArchConfig(
    name="deepseek-v2-236b", family="moe", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=160, vocab_size=512,
    rope_theta=1e4,
    moe=MoEConfig(num_experts=8, experts_per_token=2,
                  num_shared_experts=2, d_ff_expert=32,
                  first_dense_layers=1),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, qk_rope_dim=16,
                  qk_nope_dim=32, v_head_dim=32))

register(FULL, SMOKE)
