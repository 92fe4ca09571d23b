"""Decoder-only transformer LM (``repro.models.transformer``): dense or MoE
FFN, optional MoE attention, three entry points:

* ``lm_apply``      — full-sequence forward (training, evaluation);
* ``prefill_apply`` — full-sequence forward that also fills dense KV
  caches (the static engine's prompt step);
* ``decode_apply``  — one-token step against those caches.

A uniform stack's layers are stacked ``(L, ...)`` as the reference stacks
them under ``scan_layers``, and a Python loop over layer slices stands in
for ``lax.scan``; a mixed dense/MoE stack (``moe_layer_period`` > 1) is the
reference's list of per-layer dicts.  ``cfg.remat`` recomputes each layer
in the backward pass through ``torch.utils.checkpoint``, as
``jax.checkpoint`` does around the scan body; the port does so for a
per-layer list too, where the reference's unrolled loop keeps every
activation (the same values, less memory).  Under FSDP
(``distributed.sharding.fsdp_gather``) each layer gathers its blocks
inside that region, and the leaves outside the blocks are gathered once
a call.  An MoE layer of an ``moe_attention`` config runs MoE attention
(``repro_torch.core.moe_attention``) when it has no cache; it has no
cached decode path, so ``prefill_apply`` and ``decode_apply`` refuse it.
The caches are one :class:`~repro_torch.models.attention.KVCache` whose
k/v stack the layers, ``(L, B, T, Hkv, D)``, written in place, with one
length on the device that a step reads there and returns advanced: a
step reads no host value, so the static engine can capture it.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.metrics import empty_aux
from repro_torch.core.moe import moe_ffn_apply
from repro_torch.core.moe_attention import moe_attention_apply
from repro_torch.distributed.sharding import fsdp_gather
from repro_torch.models import layers as L
from repro_torch.models.attention import KVCache, attention_apply, init_cache
from repro_torch.nn.spec import is_moe_layer as _is_moe_layer


def unstack_layers(params, num_layers: int) -> list:
    """The block params as one param dict per layer: a mixed stack's list
    as it is, a stacked ``(L, ...)`` tree as views.  One ``unbind`` per
    leaf: its backward stacks the layers' gradients once, where indexing
    layer by layer would zero-fill a full-size gradient for every layer."""
    if isinstance(params, list):
        return params
    if isinstance(params, dict):
        per_key = {k: unstack_layers(v, num_layers) for k, v in params.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(num_layers)]
    return list(torch.unbind(params, 0))


def block_apply(params, x, cfg: ModelConfig, *, positions, moe_layer: bool,
                cache: Optional[KVCache] = None, use_flash: bool = False,
                ctx: Optional[MoEContext] = None):
    """Pre-norm block. Returns (x, aux, new_cache).  An MoE attention
    layer's aux losses are added into the FFN's ``*_loss`` entries."""
    h = L.norm_apply(params["ln_attn"], x, cfg)
    attn_aux = None
    if cfg.moe.moe_attention and moe_layer and cache is None:
        attn_out, attn_aux = moe_attention_apply(params["attn"], h, cfg,
                                                 positions=positions, ctx=ctx)
        new_cache = None
    else:
        attn_out, new_cache = attention_apply(params["attn"], h, cfg, positions=positions,
                                              cache=cache, use_flash=use_flash)
    x = x + attn_out
    h = L.norm_apply(params["ln_ffn"], x, cfg)
    if moe_layer:
        ffn_out, aux = moe_ffn_apply(params["ffn"], h, cfg, ctx=ctx)
        if attn_aux is not None:
            aux = {k: aux[k] + attn_aux[k] if k.endswith("_loss") else aux[k] for k in aux}
    else:
        ffn_out, aux = L.ffn_apply(params["ffn"], h, cfg), empty_aux(
            cfg.moe.num_experts, x.device)
    return x + ffn_out, aux, new_cache


def _run_blocks(params, x, cfg: ModelConfig, *, positions, caches: Optional[KVCache] = None,
                use_flash: bool = False, ctx: Optional[MoEContext] = None):
    """All layers (stacked or a per-layer list); returns (x, aux,
    new_caches) with the ``*_loss`` entries of aux summed over layers and
    the others stacked (L, ...); new_caches is None without caches."""
    if caches is not None and cfg.moe.moe_attention:
        # the reference would run dense attention over the expert weights
        raise NotImplementedError("moe_attention has no cached decode path")

    stacked = not isinstance(params["blocks"], list)

    def body(h, bp, i, cache=None):
        bp = fsdp_gather(bp, "blocks/" if stacked else f"blocks/{i}/", lead=int(stacked))
        return block_apply(bp, h, cfg, positions=positions, moe_layer=_is_moe_layer(cfg, i),
                           cache=cache, use_flash=use_flash, ctx=ctx)

    auxes = []
    for i, bp in enumerate(unstack_layers(params["blocks"], cfg.num_layers)):
        if caches is not None:
            x, aux, _ = body(x, bp, i, caches_index(caches, i))
        elif cfg.remat and torch.is_grad_enabled():
            # no RNG state stashed: the block draws no random number, and a
            # captured train step may not read the generator's state
            x, aux, _ = checkpoint(body, x, bp, i, use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux, _ = body(x, bp, i)
        auxes.append(aux)
    if caches is not None:             # every layer wrote this step's positions in place
        caches = KVCache(caches.k, caches.v, caches.length + x.shape[1])
    return x, sum_layer_aux(auxes), caches


def sum_layer_aux(auxes: list) -> dict:
    """Per-layer aux dicts -> the ``*_loss`` entries summed over layers, the
    others stacked (L, ...), as the reference's scan leaves them."""
    aux = {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}
    return {k: v.sum() if k.endswith("_loss") else v for k, v in aux.items()}


def caches_index(caches: KVCache, i: int) -> KVCache:
    """Layer ``i``'s view of the stacked caches."""
    return KVCache(caches.k[i], caches.v[i], caches.length)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, device=None) -> KVCache:
    """Zeroed caches of every layer in the activation dtype,
    ``(L, B, T, Hkv, D)``, length 0."""
    return init_cache(cfg, batch, max_len, lead=(cfg.num_layers,), device=device)


def _outer(params):
    """The params with the leaves outside the blocks gathered whole where
    the active rules place them by FSDP (once a call: a tied table serves
    the lookup and the unembedding from one gather)."""
    return {**params, **fsdp_gather({k: v for k, v in params.items() if k != "blocks"})}


def _logits(params, x, cfg: ModelConfig):
    x = L.norm_apply(params["final_norm"], x, cfg)
    return L.unembed_apply(params.get("unembed", params["embed"]), x, cfg)


def lm_apply(params, tokens, cfg: ModelConfig, *, positions=None, use_flash: bool = False,
             extra_embeds: Optional[torch.Tensor] = None,
             ctx: Optional[MoEContext] = None):
    """tokens: (B, S) int -> (logits (B, P+S, V_pad), aux).

    ``extra_embeds``: optional (B, P, d_model) prefix embeddings (m6's
    image patches) prepended to the token embeddings; positions run over
    the prefix too, and the prefix rows' token ids read -1 in the MoE
    context."""
    params = _outer(params)
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
    x, aux, _ = _run_blocks(params, x, cfg, positions=positions, use_flash=use_flash, ctx=ctx)
    return _logits(params, x, cfg), aux


def decode_apply(params, tokens, caches: KVCache, cfg: ModelConfig,
                 ctx: Optional[MoEContext] = None):
    """tokens: (B, 1) -> (logits (B, 1, V_pad), new_caches).  The MoE
    context carries the current token ids and the *absolute* positions
    ``length + arange(S)``, read from the cache length on the device, so
    identity and position routing agree between prefill and decode; the
    learned positions are those rows of the table."""
    params = _outer(params)
    x = L.embedding_apply(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    pos = caches.length + torch.arange(S, device=x.device)
    positions = pos[None, :].expand(B, S)
    ctx = (ctx or MoEContext()).with_tokens(tokens, positions)
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"].index_select(0, pos).to(x.dtype)[None]
    x, _, new_caches = _run_blocks(params, x, cfg, positions=positions, caches=caches, ctx=ctx)
    return _logits(params, x, cfg), new_caches


def prefill_apply(params, tokens, cfg: ModelConfig, *, max_len: int,
                  ctx: Optional[MoEContext] = None, caches: Optional[KVCache] = None):
    """Full forward over the prompt that fills fresh ``max_len`` caches (or
    ``caches``, empty ones of the batch's rows that the static engine
    keeps: their length must be 0); returns (logits (B, S, V_pad),
    caches, aux).

    It adds the learned positions of the prompt, as ``lm_apply`` and
    ``decode_apply`` do.  The reference's ``prefill_apply`` omits them
    (``repro/models/transformer.py:246-267``), so its static engine serves
    a learned-position model (m6) different tokens than its continuous
    engine; the port's prefill computes the prompt positions that its
    decode steps continue from."""
    params = _outer(params)
    if caches is None:
        caches = init_caches(cfg, tokens.shape[0], max_len, device=tokens.device)
    x = L.embedding_apply(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    ctx = (ctx or MoEContext()).with_tokens(tokens, positions)
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"][:S].to(x.dtype)[None]
    x, aux, caches = _run_blocks(params, x, cfg, positions=positions, caches=caches, ctx=ctx)
    return _logits(params, x, cfg), caches, aux
