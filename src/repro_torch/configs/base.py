"""Architecture + run-shape configuration system.

One ``ArchConfig`` per assigned architecture lives in ``configs/<id>.py``
(exact numbers from the assignment table).  Every config also provides a
``smoke()`` reduction — same family/wiring, tiny dims — used by the per-arch
CPU smoke tests.  ``SHAPES`` defines the four assigned input shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    num_shared_experts: int = 0
    d_ff_expert: int = 0            # per-expert FFN width
    first_dense_layers: int = 0     # leading layers with dense FFN
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0            # 0 = no query compression
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | audio | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    # attention pattern
    sliding_window: int = 0         # 0 = full attention everywhere
    local_global_period: int = 0    # gemma3: 6 (5 local + 1 global)
    local_window: int = 1024
    # family sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): a shared attention block every k mamba blocks
    shared_attn_period: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500
    # vlm (llava): image tokens prepended as precomputed patch embeddings
    num_image_tokens: int = 0
    vision_embed_dim: int = 0
    # MTP (deepseek-v3 multi-token prediction) depth
    mtp_depth: int = 0
    # §Perf: pad the q-head count up to a multiple of this so attention
    # tensors shard cleanly on the production model axis (16).  Dead heads
    # are hard-masked — semantics remain exactly ``num_heads`` heads.
    head_pad: int = 1
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch serve a 500k-token context without a dense
        full-attention cache?  (SSM state, or windowed attention with at
        most a bounded number of global layers.)"""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0 or self.local_global_period > 0


@dataclasses.dataclass(frozen=True)
class RunShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, RunShape] = {
    "train_4k": RunShape("train_4k", 4096, 256, "train"),
    "prefill_32k": RunShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": RunShape("decode_32k", 32768, 128, "decode"),
    "long_500k": RunShape("long_500k", 524288, 1, "decode"),
}


_REGISTRY: Dict[str, Tuple["ArchConfig", "ArchConfig"]] = {}


def register(full: ArchConfig, smoke: ArchConfig) -> ArchConfig:
    _REGISTRY[full.name] = (full, smoke)
    return full


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (imports every arch module)
    full, small = _REGISTRY[name]
    return small if smoke else full


def list_archs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401
    return tuple(sorted(_REGISTRY))


def cell_is_supported(cfg: ArchConfig, shape: RunShape) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and why not if it doesn't.

    Per the assignment: long_500k requires sub-quadratic attention — pure
    full-attention archs skip it (documented in DESIGN.md §4).
    """
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, ("full-attention arch: 500k dense KV cache is "
                       "architecturally unsupported (DESIGN.md §4)")
    return True, ""
