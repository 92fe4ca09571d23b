"""xlstm-125m [arXiv:2405.04517; ssm] (``repro.configs.xlstm_125m``): 12
blocks, d=768, 4 heads, every 4th block sLSTM (xLSTM[3:1]-style), d_ff=0
(the projections live inside the blocks).  No FFN, so the paper's MoE
routing does not apply."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="xlstm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    max_seq_len=524288,
    xlstm_slstm_period=4,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return CONFIG.replace(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
                          vocab_size=263, max_seq_len=256, ssm_chunk=32,
                          dtype="float32")
