"""zamba2-7b [arXiv:2411.15242; hybrid] (``repro.configs.zamba2_7b``): 81
Mamba2 layers d=3584 with a shared attention block (32H over concat(x, x0)
-> 2d, head_dim 224, d_ff=14336) applied every 6 layers; ssm_state=64,
vocab 32000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="zamba",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    max_seq_len=524288,
    ssm_state=64,
    ssm_heads=112,          # d_inner 7168 / head dim 64
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=128,
    zamba_shared_period=6,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=5, d_model=64, num_heads=4, num_kv_heads=4,
                          d_ff=96, vocab_size=263, max_seq_len=256, ssm_state=16,
                          ssm_heads=4, ssm_chunk=16, zamba_shared_period=2,
                          dtype="float32")
