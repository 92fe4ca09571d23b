"""qwen3-14b [hf:Qwen family; dense]: 40L d=5120 40H (GQA kv=8, head_dim
128) d_ff=17408, vocab 151936, qk_norm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="decoder_lm",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    max_seq_len=32768,
    rope_theta=1e6,
    qk_norm=True,
    ffn_activation="swiglu",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=80, num_heads=5, num_kv_heads=1,
                          head_dim=16, d_ff=112, vocab_size=263, max_seq_len=128,
                          dtype="float32")
