"""granite-moe-3b-a800m [hf:ibm-granite family; moe]: 32L d=1536 24H (GQA
kv=8, head_dim 64) per-expert d_ff=512, vocab 49155, 40 experts top-8.

The paper's technique applies directly: ``routing="topk", top_k=8`` is the
published baseline; ``prototyped()`` gives the M6-T 8*top-1 variant
(8 prototypes x 5 experts)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="decoder_lm",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    max_seq_len=32768,
    rope_theta=1e4,
    tie_embeddings=True,
    ffn_activation="swiglu",
    moe=MoEConfig(num_experts=40, routing="topk", top_k=8,
                  capacity_factor=1.25, group_size=512),
)


def prototyped(k: int = 8) -> ModelConfig:
    """M6-T expert prototyping variant: k prototypes of E/k experts."""
    return CONFIG.replace_moe(routing="prototype", num_prototypes=k)


def smoke() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=269, max_seq_len=128, dtype="float32",
    ).replace_moe(num_experts=8, top_k=2, group_size=64)
