"""Multi-head attention with GQA, qk-norm, RoPE and a dense KV cache
(``repro.models.attention``): the Q/K/V projection the serving engines
share; full-sequence self-attention for training and ``lm_apply``, with
the flash kernel as an optional drop-in (``use_flash=True``); the
cache branch the static engine runs; and cross-attention over a fixed
memory (the encdec family's decoder), whose K/V :func:`project_kv` makes.

The cache (:class:`KVCache`) is ``(B, T, Hkv, D)`` in the activation
dtype, written in place (the reference's jit donates it instead), so it
must be made and used under ``torch.inference_mode()``; its ``length`` is
a 0-dim int32 tensor on the cache's device, as the reference's is.  A
step reads no host value: it writes its K/V at the positions ``length +
arange(S)`` (an indexed copy) and returns the cache with the length
advanced on the device, so that an engine can capture it as a CUDA
graph.  A write past the cache's end is refused where the length lies on
the CPU; on the card the engines refuse a ``generate`` that would reach
it before any step runs.  A prefill (S > 1) attends over the cache
through the reference's ``_sdpa``, as the reference computes it outside
Pallas; a decode step (S = 1) is the dense decode attention kernel
(``repro_torch.kernels.decode_attention.decode_attention``) over the
cache, every row at length ``length + 1``, planned from the cache's
static T.  Cross-attention (``kv=``)
takes q from ``wq`` (q-norm where set, no RoPE) and the memory's K/V as
given: over S > 1 queries (teacher forcing) the reference's ``_sdpa``
without a mask, and for a decode step (S = 1) the dense decode kernel
over the memory, every row at its length S_src.  Both decode routes apply
the logit softcap (``attn_logit_softcap``) as the reference's ``_sdpa``
does.  ``_sdpa`` takes the chunked path
(:mod:`repro_torch.models.chunked_attention`) under
``attention_impl="chunked"``, or under ``"auto"`` when S*T > 2^21, as the
reference's does.  On a mesh whose rules shard the heads over the model
axis (training, and the dry run's prefill and decode), a rank's q, k and v
projections are its heads' columns and ``wo`` its heads' rows: the rank
attends over its heads, its cache holds its kv heads, and the output is
all-reduced (the input enters through ``collectives.copy_to``).  Where
the kv heads do not divide over the axis, ``wk`` and ``wv`` are whole on
every rank and a rank projects only the kv heads its q heads read; where
a rank's block of the heads is not whole heads, or where a rank's q heads
with the kv heads whole are neither whole GQA groups nor within one, the
layer gathers its projections and every rank computes every head.
Cross-attention is head-parallel the same way: :func:`project_kv` gives a rank's kv heads of
the memory (its input through ``copy_to``), the rank's q heads attend over
them, and ``wo``'s output is all-reduced."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import tensor_parallel
from repro_torch.models.layers import apply_rope, dense_apply, head_rmsnorm_apply, rope

_CHUNK_THRESHOLD = 1 << 21  # S*T above this -> the reference's chunked path under "auto"


class KVCache(NamedTuple):
    k: torch.Tensor    # (B, T, Hkv, D); the model's caches stack layers first
    v: torch.Tensor
    length: torch.Tensor   # 0-dim int32: valid positions, the same for every row


def _project_qkv(params, x, cfg: ModelConfig, positions):
    """x: (B, S, d) -> q (B, S, Hq, D), k/v (B, S, Hkv, D); a rank's heads
    where the projections are sharded by head."""
    B, S = x.shape[:2]
    hd = cfg.resolved_head_dim
    q = dense_apply(params["wq"], x, cfg).reshape(B, S, -1, hd)
    k = dense_apply(params["wk"], x, cfg).reshape(B, S, -1, hd)
    v = dense_apply(params["wv"], x, cfg).reshape(B, S, -1, hd)
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


def _sdpa(q, k, v, cfg: ModelConfig, mask, *, causal_offset=None) -> torch.Tensor:
    """Grouped SDPA with the reference's dispatch: the chunked path under
    ``"chunked"``, or under ``"auto"`` when S*T > 2^21, else the
    materialised scores.  ``mask`` is honoured only by the latter; the
    chunked path masks itself from ``causal_offset`` (None: bidirectional;
    an int or a 0-dim tensor: causal, the first query at that position)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    impl = cfg.attention_impl
    if impl == "auto":
        impl = "chunked" if S * T > _CHUNK_THRESHOLD else "reference"
    if impl != "chunked":
        return _sdpa_reference(q, k, v, cfg, mask)
    from repro_torch.models.chunked_attention import chunked_attention

    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    causal = causal_offset is not None
    out = chunked_attention(qg, k, v, causal, causal_offset if causal else 0,
                            cfg.attention_block, cfg.attn_logit_softcap)
    return out.reshape(B, S, Hq, D)


def causal_mask(S: int, T: int, offset: int = 0, device=None) -> torch.Tensor:
    """mask[s, t] = t <= s + offset, broadcast to (1,1,1,S,T)."""
    rows = torch.arange(S, device=device)[:, None] + offset
    cols = torch.arange(T, device=device)[None, :]
    return (cols <= rows)[None, None, None, :, :]


def attention_apply(params, x, cfg: ModelConfig, *, positions, causal: bool = True,
                    cache: Optional[KVCache] = None, use_flash: bool = False,
                    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x (B, S, d) -> (y (B, S, d), updated cache).  Without a cache: full
    self-attention over x (training, ``lm_apply``).  With one: this step's
    K/V are written at ``cache.length`` in place, then a prefill (S > 1)
    attends over the cache masked to ``t <= length + s`` and a decode step
    (S = 1) runs the dense decode kernel.  With ``kv=(k, v)``, headed
    (B, T, Hkv, D) memory K/V: cross-attention over all T positions (no
    cache, no RoPE)."""
    B, S, _ = x.shape
    params, x, tp = _heads_region(params, x, cfg)
    if kv is not None:
        hd = cfg.resolved_head_dim
        q = dense_apply(params["wq"], x, cfg).reshape(B, S, -1, hd)
        if cfg.qk_norm:
            q = head_rmsnorm_apply(params["q_norm"], q, cfg.norm_eps)
        k, v = kv
        if S == 1:
            lengths = torch.full((B,), k.shape[1], dtype=torch.int32, device=q.device)
            out = _decode_attention(q[:, 0].contiguous(), k, v, lengths, cfg)[:, None]
        else:
            out = _sdpa(q, k, v, cfg, mask=None)
        out = dense_apply(params["wo"], out.reshape(B, S, -1), cfg)
        return (out if tp is None else collectives.all_reduce(out, tp[0])), None
    q, k, v = _project_qkv(params, x, cfg, positions)
    new_cache = None
    if cache is not None:
        idx, T = cache.length, cache.k.shape[1]
        # the reference's write clamps silently; a length on the CPU is read
        # here, one on the card is guarded by the engine's host step count
        if idx.device.type == "cpu" and int(idx) + S > T:
            raise ValueError(f"KV cache of {T} positions cannot take {S} more at length "
                             f"{int(idx)}")
        rows = idx + torch.arange(S, device=x.device)
        cache.k.index_copy_(1, rows, k.to(cache.k.dtype))
        cache.v.index_copy_(1, rows, v.to(cache.v.dtype))
        new_cache = KVCache(cache.k, cache.v, idx + S)
        if S == 1:
            lengths = (idx + 1).to(torch.int32).expand(B).contiguous()
            out = _decode_attention(q[:, 0].contiguous(), cache.k, cache.v, lengths, cfg)
            out = out[:, None]
        else:
            mask = (torch.arange(T, device=x.device)[None, :] <= rows[:, None])[None, None, None]
            out = _sdpa(q, cache.k, cache.v, cfg, mask, causal_offset=idx)
    elif use_flash:
        from repro_torch.kernels.flash_attention import flash_attention

        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    else:
        mask = causal_mask(S, S, device=x.device) if causal else None
        out = _sdpa(q, k, v, cfg, mask, causal_offset=0 if causal else None)
    out = dense_apply(params["wo"], out.reshape(B, S, -1), cfg)
    if tp is not None:
        out = collectives.all_reduce(out, tp[0])
    return out, new_cache


def _heads_region(params, x, cfg: ModelConfig):
    """(params, x, tp) as a rank of this layer's head-parallel region uses
    them (:func:`_head_parallel`'s ``tp``, None where the rank computes
    every head): the rank's projections with the whole leaves it uses
    through ``copy_to``, and its input through ``copy_to``; or every
    head's projections gathered where a rank's block is not whole heads."""
    tp = _head_parallel(params, cfg)
    if tp is not None and tp[1] == "gather":
        return _gathered_heads(params, cfg, tp[0]), x, None
    if tp is not None:
        x = collectives.copy_to(x, tp[0])
        params = _rank_projections(params, cfg, *tp)
    return params, x, tp


def _head_parallel(params, cfg: ModelConfig):
    """Where this layer's projections hold a rank's heads (column-parallel
    q, k, v; row-parallel ``wo``): (the model axis's process group, None)
    where ``wk`` / ``wv`` hold the rank's kv heads too, or (group, (lo,
    hi)) where they are whole (the kv heads do not divide over the axis)
    and the rank's q heads read kv heads lo..hi-1; else None."""
    tp = tensor_parallel("heads")
    hd = cfg.resolved_head_dim
    if tp is None or params["wq"]["kernel"].shape[-1] == cfg.num_heads * hd:
        return None
    group, _, _ = tp
    if params["wq"]["kernel"].shape[-1] % hd:
        return group, "gather"
    if params["wk"]["kernel"].shape[-1] != cfg.num_kv_heads * hd:
        return group, None
    kv = rank_kv_heads(cfg, *tp[1:])
    return group, "gather" if kv is None else kv


def _gathered_heads(params, cfg: ModelConfig, group):
    """The layer's projections whole where a rank's block of the heads is
    not whole heads (the rules shard the heads' columns, as the reference's
    do: granite's 24 heads or qwen's 40 over 16 ranks): all-gathered over
    the model axis, so that every rank computes every head (the
    gather's backward keeps a rank its own block's gradient)."""
    hd = cfg.resolved_head_dim
    out = dict(params)
    for name, whole in (("wq", cfg.num_heads), ("wk", cfg.num_kv_heads),
                        ("wv", cfg.num_kv_heads)):
        if params[name]["kernel"].shape[-1] != whole * hd:
            out[name] = {k: collectives.all_gather(t, group, dim=t.dim() - 1, grad="slice")
                         for k, t in params[name].items()}
    wo = params["wo"]["kernel"]
    out["wo"] = {**params["wo"],
                 "kernel": collectives.all_gather(wo, group, dim=wo.dim() - 2, grad="slice")}
    return out


def rank_kv_heads(cfg: ModelConfig, n: int, r: int) -> Optional[Tuple[int, int]]:
    """The kv heads (lo, hi) that rank ``r`` of ``n`` on the heads' axis
    reads: those of its q heads ``r * Hq / n ...``; None where its q heads
    are neither whole GQA groups nor within one (the layer then gathers its
    projections: every rank computes every head)."""
    hq, G = cfg.num_heads // n, cfg.num_heads // cfg.num_kv_heads
    if hq % G and G % hq:
        return None
    return r * hq // G, ((r + 1) * hq - 1) // G + 1


def local_kv_heads(cfg: ModelConfig) -> int:
    """The kv heads a rank's cache holds under the active rules: its block
    of them, or those its q heads read where the kv heads are whole."""
    tp = tensor_parallel("heads")
    if tp is None or cfg.num_heads % tp[1]:         # no heads, or every head on every rank
        return cfg.num_kv_heads
    n = tp[1]
    if tensor_parallel("kv_heads") is not None and cfg.num_kv_heads % n == 0:
        return cfg.num_kv_heads // n
    kv = rank_kv_heads(cfg, n, tp[2])
    return cfg.num_kv_heads if kv is None else kv[1] - kv[0]


def _rank_projections(params, cfg: ModelConfig, group, kv):
    """The layer's params as a rank of a head-parallel region uses them:
    the leaves every rank holds whole and uses for its own heads (the q /
    k norms; ``wk`` / ``wv`` where the kv heads are whole, cut to the
    rank's ``kv`` heads) enter through ``collectives.copy_to``, whose
    backward sums the ranks' parts of their gradients."""
    out = dict(params)
    for name in ("q_norm", "k_norm"):
        if name in params:
            out[name] = collectives.copy_to(params[name], group)
    if kv is not None:
        hd = cfg.resolved_head_dim
        cols = slice(kv[0] * hd, kv[1] * hd)
        for name in ("wk", "wv"):
            out[name] = {k: collectives.copy_to(t, group)[..., cols]
                         for k, t in params[name].items()}
    return out


def _decode_attention(q, k_cache, v_cache, lengths, cfg: ModelConfig) -> torch.Tensor:
    """One query per row over the first ``lengths`` (B,) int32 positions of
    the dense cache (or memory): the reference's ``_sdpa`` over mask
    ``t <= cache.length`` (or no mask), softcap included, as the dense
    decode kernel computes it.  The kernel plans its launch from the
    cache's static T (no host length), so the step can be captured."""
    from repro_torch.kernels.decode_attention import decode_attention

    return decode_attention(q, k_cache, v_cache, lengths, softcap=cfg.attn_logit_softcap)


def project_kv(params, memory, cfg: ModelConfig):
    """Cross-attention K/V (B, T, Hkv, D) of the encoder memory (B, T, d),
    k-normed where ``qk_norm`` is set (no RoPE); a rank's kv heads (those
    its cache would hold, :func:`local_kv_heads`) in a head-parallel
    layer."""
    B, T, _ = memory.shape
    hd = cfg.resolved_head_dim
    params, memory, _ = _heads_region(params, memory, cfg)
    k = dense_apply(params["wk"], memory, cfg).reshape(B, T, -1, hd)
    v = dense_apply(params["wv"], memory, cfg).reshape(B, T, -1, hd)
    if cfg.qk_norm:
        k = head_rmsnorm_apply(params["k_norm"], k, cfg.norm_eps)
    return k, v


def init_cache(cfg: ModelConfig, batch: int, max_len: int, lead: Tuple[int, ...] = (),
               device=None) -> KVCache:
    """A zeroed ``lead + (B, max_len, Hkv, D)`` cache in the activation
    dtype, length 0 (a 0-dim int32 tensor on ``device``): one layer's, or
    with ``lead`` the stacked caches of several that share one length."""
    shape = lead + (batch, max_len, local_kv_heads(cfg), cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
                   torch.zeros(shape, dtype=cfg.activation_dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))
