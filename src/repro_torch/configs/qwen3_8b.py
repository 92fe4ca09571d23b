"""qwen3-8b [hf:Qwen/Qwen3-8B; dense]: 36L d=4096 32H (GQA kv=8, head_dim
128) d_ff=12288, vocab 151936, qk_norm.  Dense: the paper's MoE routing is
inapplicable (DESIGN.md 4)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    family="decoder_lm",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    max_seq_len=32768,
    rope_theta=1e6,
    qk_norm=True,
    ffn_activation="swiglu",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                          head_dim=16, d_ff=96, vocab_size=263, max_seq_len=128,
                          dtype="float32")
