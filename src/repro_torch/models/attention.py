"""Multi-head attention with GQA, qk-norm and RoPE
(``repro.models.attention``): the Q/K/V projection the serving engine
shares, and full-sequence self-attention for training and the
``lm_apply`` forward, with the flash kernel as an optional drop-in for
it (``use_flash=True``).  The decode KV cache lives in
``repro_torch.serving``; the chunked path is not ported (see
:func:`_sdpa`)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, dense_apply, head_rmsnorm_apply, rope

_CHUNK_THRESHOLD = 1 << 21  # S*T above this -> the reference's chunked path under "auto"


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


def _sdpa_reference(q, k, v, cfg: ModelConfig, mask) -> torch.Tensor:
    """Materialised-scores attention. q:(B,S,Hq,D) k/v:(B,T,Hkv,D)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * (D ** -0.5)
    if cfg.attn_logit_softcap > 0:
        c = cfg.attn_logit_softcap
        scores = torch.tanh(scores / c) * c
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def _sdpa(q, k, v, cfg: ModelConfig, mask) -> torch.Tensor:
    """The reference path; the reference's chunked path (``"chunked"``, or
    ``"auto"`` when S*T > 2^21) is not ported.  m6's learned positions cap
    S*T at 256^2, far below the threshold."""
    S, T = q.shape[1], k.shape[1]
    impl = cfg.attention_impl
    if impl == "auto":
        impl = "chunked" if S * T > _CHUNK_THRESHOLD else "reference"
    if impl == "chunked":
        raise NotImplementedError("chunked attention is not ported")
    return _sdpa_reference(q, k, v, cfg, mask)


def causal_mask(S: int, T: int, offset: int = 0, device=None) -> torch.Tensor:
    """mask[s, t] = t <= s + offset, broadcast to (1,1,1,S,T)."""
    rows = torch.arange(S, device=device)[:, None] + offset
    cols = torch.arange(T, device=device)[None, :]
    return (cols <= rows)[None, None, None, :, :]


def attention_apply(params, x, cfg: ModelConfig, *, positions, causal: bool = True,
                    use_flash: bool = False) -> torch.Tensor:
    """Full self-attention over x (B, S, d) -> (B, S, d): the reference's
    ``attention_apply`` with ``cache=None`` (training and ``lm_apply``)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg, positions)
    if use_flash:
        from repro_torch.kernels.flash_attention import flash_attention

        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    else:
        mask = causal_mask(S, S, device=x.device) if causal else None
        out = _sdpa(q, k, v, cfg, mask)
    return dense_apply(params["wo"], out.reshape(B, S, -1), cfg)
