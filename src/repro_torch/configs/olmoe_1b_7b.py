"""olmoe-1b-7b [arXiv:2409.02060; moe]: 16L d=2048 16H (kv=16, head_dim
128) per-expert d_ff=1024, vocab 50304, 64 experts top-8."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="decoder_lm",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    max_seq_len=32768,
    rope_theta=1e4,
    qk_norm=True,  # OLMoE uses QK-norm
    ffn_activation="swiglu",
    moe=MoEConfig(num_experts=64, routing="topk", top_k=8,
                  capacity_factor=1.25, group_size=512),
)


def prototyped(k: int = 8) -> ModelConfig:
    return CONFIG.replace_moe(routing="prototype", num_prototypes=k)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=48, vocab_size=311, max_seq_len=128, dtype="float32",
    ).replace_moe(num_experts=8, top_k=2, group_size=64)
