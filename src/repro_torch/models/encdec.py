"""Encoder-decoder transformer, the seamless-m4t backbone
(``repro.models.encdec``).

The speech/audio frontend is a stub, as in the reference: :func:`encode`
takes precomputed frame embeddings (B, S_src, d_model), f32 from the
pipeline, and casts them to the activation dtype.  The encoder is dense
with bidirectional self-attention and RoPE at the frame positions; the
decoder is a causal transformer whose every block adds cross-attention
over the encoder's output.  Where ``cfg.moe.num_experts`` > 0 every
decoder FFN is an MoE layer (the encoder stays dense), with the MoE
context carrying the target tokens and their absolute positions, so
routing agrees between teacher forcing and decode.

Both stacks are stacked ``(L, ...)`` (``nn.spec.encdec_shapes``), and a
Python loop over layer views stands in for the reference's ``lax.scan``;
``cfg.remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``), as ``jax.checkpoint`` does around the scan
bodies.  As in the reference, the one embedding table also unembeds
whatever ``tie_embeddings`` says, and no learned positions are added
under ``pos_embed="learned"``.

Decode (:func:`init_state`, :func:`decode_step`) precomputes every decoder
layer's cross-attention K/V of the memory once and keeps one dense
self-attention cache a layer, stacked ``(L, B, T, Hkv, D)`` with one
length on the device (:class:`~repro_torch.models.attention.KVCache`),
written in place, so a state is made and used under
``torch.inference_mode()``.  The step runs eagerly: the reference compiles
no encdec decode step.
A decode step (S = 1) runs the dense decode attention kernel twice a
layer: over the layer's self cache, every row at length + 1, and over its
cross K/V, every row at S_src.  No serving engine takes this family, as
in the reference (``models.registry``).  Under FSDP
(``sharding.fsdp_gather``) each block gathers its leaves inside its remat
region, and each function gathers the outer leaves it reads once a call
(the one table serves the lookup and the unembedding from one gather)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.metrics import empty_aux
from repro_torch.core.moe import moe_ffn_apply
from repro_torch.distributed.sharding import fsdp_gather
from repro_torch.models import layers as L
from repro_torch.models.attention import KVCache, attention_apply, project_kv
from repro_torch.models.transformer import (
    caches_index,
    init_caches,
    sum_layer_aux,
    unstack_layers,
)


class EncDecState(NamedTuple):
    self_cache: KVCache        # k / v (L, B, T, Hkv, D), one length
    cross_k: torch.Tensor      # (L, B, S_src, Hkv, D)
    cross_v: torch.Tensor


def _remat(cfg: ModelConfig) -> bool:
    return cfg.remat and torch.is_grad_enabled()


def _outer(params, *keys):
    """``params`` with the outer leaves ``keys`` gathered whole where the
    active rules place them by FSDP (once a call)."""
    return {**params, **fsdp_gather({k: params[k] for k in keys})}


def encode(params, frames, cfg: ModelConfig):
    """frames (B, S_src, d_model) -> the memory (B, S_src, d_model)."""
    B, S, _ = frames.shape
    positions = torch.arange(S, device=frames.device)[None, :].expand(B, S)
    x = frames.to(cfg.activation_dtype)
    params = _outer(params, "enc_norm")

    def body(h, bp):
        bp = fsdp_gather(bp, "encoder/", lead=1)
        a = L.norm_apply(bp["ln_attn"], h, cfg)
        attn, _ = attention_apply(bp["attn"], a, cfg, positions=positions, causal=False)
        h = h + attn
        f = L.norm_apply(bp["ln_ffn"], h, cfg)
        return h + L.ffn_apply(bp["ffn"], f, cfg)

    for bp in unstack_layers(params["encoder"], cfg.num_encoder_layers or cfg.num_layers):
        x = (checkpoint(body, x, bp, use_reentrant=False, preserve_rng_state=False)
             if _remat(cfg) else body(x, bp))
    return L.norm_apply(params["enc_norm"], x, cfg)


def _dec_block(bp, h, memory_kv, cfg: ModelConfig, *, positions,
               cache: Optional[KVCache] = None, ctx: Optional[MoEContext] = None):
    """Self-attention, cross-attention over ``memory_kv``, FFN; returns
    (h, aux, new_cache)."""
    a = L.norm_apply(bp["ln_self"], h, cfg)
    attn, new_cache = attention_apply(bp["self_attn"], a, cfg, positions=positions,
                                      cache=cache)
    h = h + attn
    c = L.norm_apply(bp["ln_cross"], h, cfg)
    cross, _ = attention_apply(bp["cross_attn"], c, cfg, positions=positions, kv=memory_kv)
    h = h + cross
    f = L.norm_apply(bp["ln_ffn"], h, cfg)
    if cfg.moe.num_experts > 0:
        ffn, aux = moe_ffn_apply(bp["ffn"], f, cfg, ctx=ctx)
    else:
        ffn, aux = L.ffn_apply(bp["ffn"], f, cfg), empty_aux(cfg.moe.num_experts, h.device)
    return h + ffn, aux, new_cache


def _positions(start, B: int, S: int, device):
    """(B, S) positions from ``start`` (0, or a cache's device length)."""
    return (start + torch.arange(S, device=device))[None, :].expand(B, S)


def decode_train(params, tokens, memory, cfg: ModelConfig, ctx: Optional[MoEContext] = None):
    """Teacher-forcing decoder forward over ``memory`` (the encoder's
    output); returns (logits (B, S, V_pad), aux)."""
    params = _outer(params, "embed", "final_norm")
    x = L.embedding_apply(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    positions = _positions(0, B, S, x.device)
    ctx = (ctx or MoEContext()).with_tokens(tokens, positions)

    def body(h, bp):
        bp = fsdp_gather(bp, "decoder/", lead=1)
        mem_kv = project_kv(bp["cross_attn"], memory, cfg)
        h, aux, _ = _dec_block(bp, h, mem_kv, cfg, positions=positions, ctx=ctx)
        return h, aux

    auxes = []
    for bp in unstack_layers(params["decoder"], cfg.num_layers):
        x, aux = (checkpoint(body, x, bp, use_reentrant=False, preserve_rng_state=False)
                  if _remat(cfg) else body(x, bp))
        auxes.append(aux)
    x = L.norm_apply(params["final_norm"], x, cfg)
    return L.unembed_apply(params["embed"], x, cfg), sum_layer_aux(auxes)


def encdec_train_apply(params, frames, tokens, cfg: ModelConfig,
                       ctx: Optional[MoEContext] = None):
    """frames (B, S_src, d), tokens (B, S) -> (logits (B, S, V_pad), aux)."""
    return decode_train(params, tokens, encode(params, frames, cfg), cfg, ctx=ctx)


def init_state(params, memory, cfg: ModelConfig, max_len: int) -> EncDecState:
    """Every decoder layer's cross K/V of ``memory`` and zeroed
    ``max_len`` self caches, length 0, on the memory's device."""
    kvs = [project_kv(fsdp_gather(bp["cross_attn"], "decoder/cross_attn/", lead=1), memory, cfg)
           for bp in unstack_layers(params["decoder"], cfg.num_layers)]
    caches = init_caches(cfg, memory.shape[0], max_len, device=memory.device)
    return EncDecState(caches, torch.stack([k for k, _ in kvs]),
                       torch.stack([v for _, v in kvs]))


def decode_step(params, tokens, state: EncDecState, cfg: ModelConfig,
                ctx: Optional[MoEContext] = None):
    """tokens (B, S) -> (logits (B, S, V_pad), new state): the self caches
    take this step's K/V in place at their length.  Positions are absolute,
    from that length, and the MoE context carries them with the tokens."""
    params = _outer(params, "embed", "final_norm")
    x = L.embedding_apply(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    caches = state.self_cache
    positions = _positions(caches.length, B, S, x.device)
    ctx = (ctx or MoEContext()).with_tokens(tokens, positions)
    for i, bp in enumerate(unstack_layers(params["decoder"], cfg.num_layers)):
        x, _, _ = _dec_block(fsdp_gather(bp, "decoder/", lead=1), x,
                             (state.cross_k[i], state.cross_v[i]), cfg,
                             positions=positions, cache=caches_index(caches, i), ctx=ctx)
    x = L.norm_apply(params["final_norm"], x, cfg)
    new_caches = KVCache(caches.k, caches.v, caches.length + S)
    return L.unembed_apply(params["embed"], x, cfg), state._replace(self_cache=new_caches)
