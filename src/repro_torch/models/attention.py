"""Q/K/V projection (``repro.models.attention._project_qkv``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, dense_apply, head_rmsnorm_apply, rope


def _project_qkv(params, x, cfg: ModelConfig, positions):
    """x: (B, S, d) -> q (B, S, Hq, D), k/v (B, S, Hkv, D)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q = dense_apply(params["wq"], x, cfg).reshape(B, -1, cfg.num_heads, hd)
    k = dense_apply(params["wk"], x, cfg).reshape(B, -1, cfg.num_kv_heads, hd)
    v = dense_apply(params["wv"], x, cfg).reshape(B, -1, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = head_rmsnorm_apply(params["q_norm"], q, cfg.norm_eps)
        k = head_rmsnorm_apply(params["k_norm"], k, cfg.norm_eps)
    if cfg.pos_embed == "rope":
        sin, cos = rope(positions, hd, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v
