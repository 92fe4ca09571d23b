"""pixtral-12b [hf:mistralai/Pixtral-12B-2409; vlm]: mistral-nemo decoder
backbone 40L d=5120 32H (GQA kv=8, head_dim 128) d_ff=14336, vocab 131072.
The pixtral-ViT frontend is a STUB: ``input_specs`` supplies precomputed
patch embeddings (B, num_image_tokens, d_model)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    max_seq_len=131072,
    rope_theta=1e6,
    ffn_activation="swiglu",
    num_image_tokens=1024,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                          head_dim=16, d_ff=96, vocab_size=263, max_seq_len=256,
                          num_image_tokens=8, dtype="float32")
