"""seamless-m4t-large-v2 [arXiv:2308.11596; audio enc-dec]
(``repro.configs.seamless_m4t_large_v2``): 24L encoder + 24L decoder,
d=1024 16H (kv=16, head_dim 64), d_ff=8192, vocab 256206.  The speech
frontend is a stub: the encoder takes precomputed frame embeddings
(B, S, d_model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    max_seq_len=32768,
    norm="layernorm",
    ffn_activation="relu",
    rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, num_encoder_layers=2, d_model=64,
                          num_heads=4, num_kv_heads=4, head_dim=16, d_ff=96,
                          vocab_size=263, max_seq_len=128, dtype="float32")
