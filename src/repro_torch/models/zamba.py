"""Zamba2-style hybrid (arXiv:2411.15242; ``repro.models.zamba``): a Mamba2
backbone with one *shared* transformer block (attention + MLP, its weights
reused) applied at the start of every ``cfg.zamba_shared_period`` layers
on ``concat(x, x0)`` (x0 the embeddings), projected back to d_model and
added to the residual stream.  As in the reference, the shared block has
no per-application LoRA adapters and the SSD B / C one group.

The shared block attends at width 2 d over ``num_heads`` heads (head_dim
2 d / heads: 224 at zamba2-7b).  Its decode step (S = 1) is the dense
decode attention kernel over that application's own cache
(``models.attention``), one launch per application, ceil(L / period) a
step.

The decode state (:class:`ZambaState`) holds every layer's Mamba2 state,
stacked ``(L, ...)``, and the applications' caches as one
:class:`~repro_torch.models.attention.KVCache` whose k / v stack them,
``(n_shared, B, T, Hkv, D)``, with one length on the device (every
application writes the same positions, and a step advances it once).
Both are written in place, as the port's caches are, so a state is made
and used under ``torch.inference_mode()``; decode positions come from
that length, as the reference takes them from the first cache's, and a
step reads no host value.

The reference's scan over segments and its unrolled loop compute the
same thing; the port has one loop over :func:`_segments`.  ``cfg.remat``
recomputes each Mamba2 block and each shared application in the backward
pass (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
does around the scan bodies.  Under FSDP (``sharding.fsdp_gather``) each
Mamba2 block gathers its leaves inside its remat region; the shared block,
the table and the final norm are gathered once a call, so that the shared
block's gradient sums over its applications on a rank before it sums over
the data ranks, in the order of the run without FSDP."""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.metrics import empty_aux
from repro_torch.distributed.sharding import fsdp_gather
from repro_torch.models import layers as L
from repro_torch.models.attention import KVCache, attention_apply, init_cache
from repro_torch.models.mamba2 import (
    Mamba2State,
    mamba2_block_apply,
    mamba2_block_shapes,
    mamba2_init_state,
)
from repro_torch.models.transformer import caches_index, unstack_layers
from repro_torch.nn.spec import ParamShape, _block, _norm, padded_vocab


class ZambaState(NamedTuple):
    mamba: Mamba2State   # every layer's, stacked (L, B, ...)
    attn: KVCache        # k / v (n_shared, B, T, Hkv, D), one device length


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg.replace(d_model=2 * cfg.d_model, head_dim=2 * cfg.d_model // cfg.num_heads,
                       ffn_activation="gelu")


def _n_shared(cfg: ModelConfig) -> int:
    return math.ceil(cfg.num_layers / cfg.zamba_shared_period)


def zamba_shapes(cfg: ModelConfig, train: bool = False):
    """Param shape tree, key for key the reference's ``zamba_specs``: the
    Mamba2 blocks stacked ``(L, ...)``, the shared block at width 2 d
    (storage dtypes as ``nn.spec``'s module doc sets out)."""
    wdt = cfg.param_dtype if train else cfg.dtype
    scfg = _shared_cfg(cfg)
    table = ParamShape((padded_vocab(cfg.vocab_size), cfg.d_model), wdt, "normal",
                       ("vocab", "embed"))
    shared = _block(scfg, wdt, (), moe_layer=False)
    shared["out"] = ParamShape((2 * cfg.d_model, cfg.d_model), wdt, "normal", (None, "embed"))
    return {"embed": {"table": table},
            "mamba": mamba2_block_shapes(cfg, wdt, (cfg.num_layers,)),
            "shared": shared, "final_norm": _norm(cfg)}


def _shared_block(params, x, x0, cfg: ModelConfig, *, positions,
                  cache: Optional[KVCache] = None):
    scfg = _shared_cfg(cfg)
    y = torch.cat([x, x0], dim=-1)
    h = L.norm_apply(params["ln_attn"], y, scfg)
    attn, new_cache = attention_apply(params["attn"], h, scfg, positions=positions, cache=cache)
    y = y + attn
    h = L.norm_apply(params["ln_ffn"], y, scfg)
    y = y + L.ffn_apply(params["ffn"], h, scfg)
    return x + y @ params["out"].to(x.dtype), new_cache


def _segments(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """(start, stop) of each shared application's Mamba2 layers."""
    p = cfg.zamba_shared_period
    return [(start, min(start + p, cfg.num_layers)) for start in range(0, cfg.num_layers, p)]


def zamba_apply(params, tokens, cfg: ModelConfig, *, state: Optional[ZambaState] = None):
    """tokens (B, S) -> (logits (B, S, V_pad), aux, new state).  A state
    means a one-token decode step that writes the state in place; the
    unembedding is tied to the embedding table."""
    decode = state is not None
    # the outer leaves and the shared block gathered once a call: the shared
    # block's gradient sums over its applications before the data ranks
    params = {**params, **fsdp_gather({k: v for k, v in params.items() if k != "mamba"})}
    x = L.embedding_apply(params["embed"], tokens, cfg)
    x0 = x
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    if decode:
        positions = state.attn.length + positions
    positions = positions[None, :].expand(B, S)
    remat = cfg.remat and not decode and torch.is_grad_enabled()
    layers = unstack_layers(params["mamba"], cfg.num_layers)

    def shared(sp, h, h0):
        return _shared_block(sp, h, h0, cfg, positions=positions)[0]

    def mamba(bp, h, st=None):
        return mamba2_block_apply(fsdp_gather(bp, "mamba/", lead=1), h, cfg, state=st)

    for si, (start, stop) in enumerate(_segments(cfg)):
        if decode:
            x, _ = _shared_block(params["shared"], x, x0, cfg, positions=positions,
                                 cache=caches_index(state.attn, si))
        elif remat:
            x = checkpoint(shared, params["shared"], x, x0, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = shared(params["shared"], x, x0)
        for li in range(start, stop):
            if decode:
                st = Mamba2State(state.mamba.h[li], state.mamba.conv[li])
                x, new = mamba(layers[li], x, st)
                st.h.copy_(new.h)
                st.conv.copy_(new.conv)
            elif remat:
                x = checkpoint(mamba, layers[li], x, use_reentrant=False,
                               preserve_rng_state=False)[0]
            else:
                x = mamba(layers[li], x)[0]
    x = L.norm_apply(params["final_norm"], x, cfg)
    logits = L.unembed_apply(params["embed"], x, cfg)
    new_state = None
    if decode:
        a = state.attn
        new_state = ZambaState(state.mamba, KVCache(a.k, a.v, a.length + S))
    return logits, empty_aux(device=x.device), new_state


def zamba_init_state(cfg: ModelConfig, batch: int, max_len: int, device=None) -> ZambaState:
    """Zeroed f32 Mamba2 states of every layer and ``n_shared`` empty
    ``max_len`` caches in the activation dtype, length 0."""
    return ZambaState(mamba2_init_state(cfg, batch, device, lead=(cfg.num_layers,)),
                      init_cache(_shared_cfg(cfg), batch, max_len, lead=(_n_shared(cfg),),
                                 device=device))
