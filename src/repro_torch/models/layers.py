"""Shared layers (``repro.models.layers``): norms, embeddings, RoPE,
dense/GLU FFN.  Norms compute in float32 and return the input dtype;
matmul weights arrive already in the activation dtype (see
``repro_torch.nn.spec``)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.spec import padded_vocab  # noqa: F401  (public here as in the reference)


def norm_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x32 = x.float()
    if cfg.norm == "layernorm":
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"] + params["bias"]
    else:
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + cfg.norm_eps) * params["scale"]
    return y.to(x.dtype)


def head_rmsnorm_apply(scale, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def embedding_apply(params, token_ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["table"].to(cfg.activation_dtype)[token_ids]


def unembed_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits over the padded vocab; padded entries masked to the
    dtype's most negative finite value."""
    table = params["table"].to(cfg.activation_dtype)
    logits = x @ table.t()
    v_pad = table.shape[0]
    if v_pad != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = torch.finfo(logits.dtype).min
    return logits


def rope(positions: torch.Tensor, head_dim: int, theta: float
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); sin/cos: (..., S, D//2) broadcast over heads."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def dense_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y = x @ params["kernel"].to(cfg.activation_dtype)
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def activation(name: str, x: torch.Tensor, gate=None) -> torch.Tensor:
    """``jax.nn.gelu`` defaults to the tanh form, hence approximate="tanh"."""
    if name == "swiglu":
        return F.silu(x) * gate
    if name == "geglu":
        return F.gelu(x, approximate="tanh") * gate
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation {name}")


def ffn_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = dense_apply(params["up"], x, cfg)
    gate = None
    if "gate" in params:
        gate = up
        up = dense_apply(params["gate"], x, cfg)
    return dense_apply(params["down"], activation(cfg.ffn_activation, up, gate), cfg)
