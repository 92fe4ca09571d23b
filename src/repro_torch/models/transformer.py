"""Decoder-only transformer LM (``repro.models.transformer``): the
full-sequence forward that training and evaluation use.

Layers are stacked ``(L, ...)`` as the reference stacks them under
``scan_layers``; a Python loop over layer slices stands in for
``lax.scan``, and ``cfg.remat`` recomputes each layer in the backward
pass through ``torch.utils.checkpoint`` as ``jax.checkpoint`` does around
the scan body.  Decoding runs in ``repro_torch.serving``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.metrics import empty_aux
from repro_torch.core.moe import moe_ffn_apply
from repro_torch.models import layers as L
from repro_torch.models.attention import attention_apply


def _is_moe_layer(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.moe.num_experts > 0 and (layer_idx % cfg.moe_layer_period == 0)


def unstack_layers(params, num_layers: int) -> list:
    """The stacked ``(L, ...)`` block params as one param dict per layer
    (views).  One ``unbind`` per leaf: its backward stacks the layers'
    gradients once, where indexing layer by layer would zero-fill a
    full-size gradient for every layer."""
    if isinstance(params, dict):
        per_key = {k: unstack_layers(v, num_layers) for k, v in params.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(num_layers)]
    return list(torch.unbind(params, 0))


def block_apply(params, x, cfg: ModelConfig, *, positions, moe_layer: bool,
                use_flash: bool = False, ctx: Optional[MoEContext] = None):
    """Pre-norm block. Returns (x, aux)."""
    h = L.norm_apply(params["ln_attn"], x, cfg)
    x = x + attention_apply(params["attn"], h, cfg, positions=positions,
                            use_flash=use_flash)
    h = L.norm_apply(params["ln_ffn"], x, cfg)
    if moe_layer:
        ffn_out, aux = moe_ffn_apply(params["ffn"], h, cfg, ctx=ctx)
    else:
        ffn_out, aux = L.ffn_apply(params["ffn"], h, cfg), empty_aux(
            cfg.moe.num_experts, x.device)
    return x + ffn_out, aux


def _run_blocks(params, x, cfg: ModelConfig, *, positions, use_flash: bool = False,
                ctx: Optional[MoEContext] = None):
    """All layers over the stacked block tree; returns (x, aux) with the
    ``*_loss`` entries summed over layers and the others stacked (L, ...)."""
    moe_layer = _is_moe_layer(cfg, 0)

    def body(h, bp):
        return block_apply(bp, h, cfg, positions=positions, moe_layer=moe_layer,
                           use_flash=use_flash, ctx=ctx)

    auxes = []
    for bp in unstack_layers(params["blocks"], cfg.num_layers):
        if cfg.remat and torch.is_grad_enabled():
            x, aux = checkpoint(body, x, bp, use_reentrant=False)
        else:
            x, aux = body(x, bp)
        auxes.append(aux)
    aux = {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}
    for k in aux:
        if k.endswith("_loss"):
            aux[k] = aux[k].sum()
    return x, aux


def lm_apply(params, tokens, cfg: ModelConfig, *, positions=None, use_flash: bool = False,
             extra_embeds: Optional[torch.Tensor] = None,
             ctx: Optional[MoEContext] = None):
    """tokens: (B, S) int -> (logits (B, P+S, V_pad), aux).

    ``extra_embeds``: optional (B, P, d_model) prefix embeddings (m6's
    image patches) prepended to the token embeddings; positions run over
    the prefix too, and the prefix rows' token ids read -1 in the MoE
    context."""
    if cfg.moe.num_experts > 0 and cfg.moe_layer_period != 1:
        raise NotImplementedError("mixed dense/MoE layer stacks are not ported")
    x = L.embedding_apply(params["embed"], tokens, cfg)
    prefix = 0
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        prefix = extra_embeds.shape[1]
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    ctx = (ctx or MoEContext()).with_tokens(tokens, positions, prefix_len=prefix)
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"][:S].to(x.dtype)[None]
    x, aux = _run_blocks(params, x, cfg, positions=positions, use_flash=use_flash, ctx=ctx)
    x = L.norm_apply(params["final_norm"], x, cfg)
    logits = L.unembed_apply(params.get("unembed", params["embed"]), x, cfg)
    return logits, aux
