"""qwen2.5-32b [hf:Qwen family; dense]: 64L d=5120 40H (GQA kv=8,
head_dim 128) d_ff=27648, vocab 152064, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="decoder_lm",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    max_seq_len=32768,
    rope_theta=1e6,
    qkv_bias=True,
    ffn_activation="swiglu",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                          head_dim=16, d_ff=96, vocab_size=263, max_seq_len=128,
                          dtype="float32")
