"""deepseek-7b [arXiv:2401.02954; dense llama-arch]: 30L d=4096 32H
(kv=32, head_dim 128) d_ff=11008, vocab 102400."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="decoder_lm",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    max_seq_len=32768,
    rope_theta=1e4,
    ffn_activation="swiglu",
)


def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                          head_dim=16, d_ff=96, vocab_size=263, max_seq_len=128,
                          dtype="float32")
