"""The paper's own M6 MoE configs (Table 5), as in ``repro.configs.m6``.

All share hidden 1024, 16 heads (head_dim 64), LayerNorm, gelu expert FFN
(2 matrices), learned positions, vocab 21128, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig


def _m6(name, layers, d_ff, experts, init_range=0.02, **moe_kw) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="m6",
        num_layers=layers,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=d_ff,
        vocab_size=21128,
        max_seq_len=256,
        norm="layernorm",
        pos_embed="learned",
        ffn_activation="gelu",
        tie_embeddings=True,
        num_image_tokens=16,
        initializer_range=init_range,
        moe=MoEConfig(num_experts=experts, routing="topk", top_k=1,
                      capacity_factor=1.25, aux_loss_coef=0.0,
                      group_size=1024, **moe_kw),
    )


M6_BASE = _m6("m6-base", 5, 4096, 32)
M6_10B = _m6("m6-10b", 10, 4096, 128)
M6_100B = _m6("m6-100b", 24, 4096, 512)
M6_1T = _m6("m6-1t", 24, 21248, 960, init_range=0.002)

CONFIG = M6_BASE


def variant(base: ModelConfig, routing: str, k: int, capacity_mode: str = "k") -> ModelConfig:
    """The paper's ablation grid (Top-1/2/4, 2/4 Top-1, Capacity kx / 1x),
    and any other registered router k-way (``repro.configs.m6.variant``)."""
    if routing == "prototype":
        return base.replace_moe(routing="prototype", num_prototypes=k,
                                prototype_top_k=1, capacity_mode=capacity_mode)
    return base.replace_moe(routing=routing, top_k=k, capacity_mode=capacity_mode)


def smoke() -> ModelConfig:
    return M6_BASE.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=263, max_seq_len=64, num_image_tokens=4,
        dtype="float32",
    ).replace_moe(num_experts=8, group_size=32)
