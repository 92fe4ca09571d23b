"""Analytic FLOP / HBM-byte models per (architecture family, shape),
``repro.distributed.costs`` line for line.

Why analytic: the reference's XLA cost analysis counts a while-loop body
once, so it undercounts what runs inside ``lax.scan``; the port has no XLA
and counts what its eager trace runs (:func:`counted_flops`, over a
``meta`` trace).  The dry run computes the roofline terms from these
models and records the counted FLOPs beside them; the tests hold the
models to the reference's and the count to the models (0.6-1.7x, the
reference's own band).

Conventions: a matmul of (m,k)x(k,n) is 2mkn FLOPs.  Backward = 2x
forward; full remat adds one forward recompute (train = 4x fwd).  Bytes
are HBM traffic with documented access-count factors — napkin-math level,
good to ~2x, which is enough to identify the dominant roofline term.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig


def counted_flops(fn, *args, **kwargs) -> float:
    """The FLOPs that ``torch.utils.flop_counter.FlopCounterMode`` counts
    while ``fn(*args, **kwargs)`` runs (on ``meta`` tensors, it allocates
    and computes nothing): the counterpart of the reference's
    ``cost_analysis_dict(compiled)["flops"]``.  Unlike XLA's cost analysis,
    which counts a ``lax.scan`` body once, it counts every op the Python
    loops run (every layer, every chunk), so it needs no trip-count fix.
    It counts matmuls, convolutions and attention, not elementwise ops,
    and a backward that ``fn`` runs (``torch.autograd.grad``) as well."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def moe_rows_per_token(m, tokens_per_group: int) -> float:
    """Expert-buffer rows processed per routed token (E*C / T_g).

    Capacity-ful: k_eff * gamma (padded capacity slots compute too).
    Dropless (capacity_factor=None): the sorted ragged buffer — routed
    choices (active_k per token) plus block-alignment padding, using the
    same adaptive block size the dispatcher picks.  capacity_mode does
    not clamp anything in dropless mode.
    """
    if m.capacity_factor is None:
        from repro_torch.kernels.moe_dropless.ops import padded_rows, pick_block_rows

        n = m.active_k * tokens_per_group
        bx = pick_block_rows(n, m.num_experts)
        return padded_rows(n, m.num_experts, bx) / float(tokens_per_group)
    k_eff = 1 if m.capacity_mode == "one" else m.active_k
    return k_eff * m.capacity_factor


def _moe_terms(cfg: ModelConfig, tokens_per_group: int) -> Dict[str, float]:
    """Per-token FLOPs for router, dispatch/combine, expert FFN."""
    m = cfg.moe
    d = cfg.d_model
    if m.num_experts == 0:
        n_mats = 3 if cfg.ffn_activation in ("swiglu", "geglu") else 2
        return {"router": 0.0, "dispatch": 0.0,
                "expert": 2.0 * d * cfg.d_ff * n_mats}
    cap_total = moe_rows_per_token(m, tokens_per_group)
    router = 2.0 * d * m.num_experts
    if m.impl == "einsum":
        # dispatch 'gtec,gtm->egcm' + combine: 2 * (E*C) * M each
        dispatch = 2.0 * 2.0 * cap_total * tokens_per_group * d
    else:  # gather / pallas: data movement only
        dispatch = 0.0
    n_mats = 3 if cfg.ffn_activation in ("swiglu", "geglu") else 2
    expert = cap_total * 2.0 * d * cfg.d_ff * n_mats  # padded rows compute too
    return {"router": router, "dispatch": dispatch, "expert": expert}


def _attn_proj_flops(cfg: ModelConfig, d: float = None) -> float:
    d = d or cfg.d_model
    hd = cfg.resolved_head_dim
    return 2.0 * d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)


def _lm_layer_fwd(cfg: ModelConfig, kv_len: float, tokens_per_group: int) -> float:
    """Per-token forward FLOPs of one decoder layer, attending kv_len."""
    hd = cfg.resolved_head_dim
    attn = _attn_proj_flops(cfg) + 2.0 * 2.0 * cfg.num_heads * hd * kv_len
    moe = _moe_terms(cfg, tokens_per_group)
    return attn + sum(moe.values())


def _groups(cfg: ModelConfig, total_tokens: int) -> int:
    from repro_torch.core.moe import _largest_divisor_leq

    return _largest_divisor_leq(total_tokens, max(total_tokens // cfg.moe.group_size, 1))


def _unembed_flops(cfg: ModelConfig) -> float:
    from repro_torch.nn.spec import padded_vocab

    return 2.0 * cfg.d_model * padded_vocab(cfg.vocab_size)


# ---------------------------------------------------------------------------
# FLOPs per family
# ---------------------------------------------------------------------------

def _decoder_lm_fwd_flops(cfg: ModelConfig, tokens: float, kv_len: float) -> float:
    tpg = (cfg.moe.group_size if cfg.moe.num_experts else 1)
    per_tok = _lm_layer_fwd(cfg, kv_len, tpg) * cfg.num_layers + _unembed_flops(cfg)
    return per_tok * tokens


def _xlstm_fwd_flops(cfg: ModelConfig, tokens: float, kv_len: float, decode: bool) -> float:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = cfg.num_heads
    dh = d_in // H
    W = dh if decode else min(cfg.ssm_chunk, kv_len)
    n_sl = sum(1 for i in range(cfg.num_layers)
               if cfg.xlstm_slstm_period and i % cfg.xlstm_slstm_period == cfg.xlstm_slstm_period - 1)
    n_ml = cfg.num_layers - n_sl
    # mLSTM block per token
    proj = 2.0 * d * d_in * 2 + 2.0 * d_in * d_in * 3 + 2.0 * d_in * d + 2.0 * d_in * 2 * H
    cell = 4.0 * W * d_in + 6.0 * dh * d_in  # intra-chunk + state in/out
    if decode:
        cell = 6.0 * dh * d_in
    ml = proj + cell
    # sLSTM block per token
    pf = int(d * 4 / 3) // 8 * 8 or 8
    sl = 2.0 * d * 4 * d + 2.0 * d * 4 * dh + 2.0 * d * 2 * pf + 2.0 * pf * d
    return (n_ml * ml + n_sl * sl + _unembed_flops(cfg)) * tokens


def _mamba_layer_fwd(cfg: ModelConfig, decode: bool) -> float:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    N = cfg.ssm_state
    H = cfg.ssm_heads or max(d_in // 64, 1)
    P = d_in // H
    W = 1 if decode else cfg.ssm_chunk
    proj = 2.0 * d * (2 * d_in + 2 * N + H) + 2.0 * d_in * d
    conv = 2.0 * cfg.ssm_conv_width * (d_in + 2 * N)
    if decode:
        cell = 4.0 * H * P * N  # state update + readout
    else:
        # intra: scores (W*N shared + 2*W*P*H) + off/state: 4*N*P*H
        cell = 2.0 * W * N + 2.0 * W * d_in + 4.0 * N * d_in
    return proj + conv + cell


def _zamba_fwd_flops(cfg: ModelConfig, tokens: float, kv_len: float, decode: bool) -> float:
    import math

    d2 = 2 * cfg.d_model
    hd2 = d2 // cfg.num_heads
    n_shared = math.ceil(cfg.num_layers / cfg.zamba_shared_period)
    # shared block on 2d: qkvo + quadratic + gelu ffn (2 mats... ffn_specs
    # with gelu -> up+down) + out proj
    attn = (2.0 * d2 * hd2 * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
            + 4.0 * cfg.num_heads * hd2 * kv_len)
    ffn = 2.0 * d2 * cfg.d_ff * 2
    shared = attn + ffn + 2.0 * d2 * cfg.d_model
    mamba = _mamba_layer_fwd(cfg, decode) * cfg.num_layers
    return (mamba + n_shared * shared + _unembed_flops(cfg)) * tokens


def _encdec_fwd_flops(cfg: ModelConfig, tokens: float, src_len: float) -> float:
    hd = cfg.resolved_head_dim
    n_mats = 3 if cfg.ffn_activation in ("swiglu", "geglu") else 2
    ffn = 2.0 * cfg.d_model * cfg.d_ff * n_mats
    enc_layer = _attn_proj_flops(cfg) + 4.0 * cfg.num_heads * hd * src_len + ffn
    # decoder: causal self (avg kv_len/2) + cross attending src_len
    dec_layer = (_attn_proj_flops(cfg) + 4.0 * cfg.num_heads * hd * (src_len / 2)
                 + _attn_proj_flops(cfg) + 4.0 * cfg.num_heads * hd * src_len + ffn)
    n_enc = cfg.num_encoder_layers or cfg.num_layers
    return (n_enc * enc_layer + cfg.num_layers * dec_layer + _unembed_flops(cfg)) * tokens


def flops_for(cfg: ModelConfig, shape: ShapeConfig, *,
              attention_impl: str = "reference") -> float:
    """Total program FLOPs for one step of this cell."""
    S, B = shape.seq_len, shape.global_batch
    if shape.kind == "train":
        tokens, kv = float(S * B), S / 2.0
        mult = 4.0 if cfg.remat else 3.0   # fwd + (refwd) + bwd
    elif shape.kind == "prefill":
        tokens, kv, mult = float(S * B), S / 2.0, 1.0
    else:  # decode: one token against a kv_len cache
        tokens, kv, mult = float(B), float(S), 1.0

    if cfg.family == "xlstm":
        fwd = _xlstm_fwd_flops(cfg, tokens, kv, shape.kind == "decode")
    elif cfg.family == "zamba":
        fwd = _zamba_fwd_flops(cfg, tokens, kv, shape.kind == "decode")
    elif cfg.family == "encdec":
        fwd = _encdec_fwd_flops(cfg, tokens, float(S))
    else:
        fwd = _decoder_lm_fwd_flops(cfg, tokens, kv)
    return fwd * mult


# ---------------------------------------------------------------------------
# Bytes per family (HBM traffic)
# ---------------------------------------------------------------------------

ACT_RW_FACTOR = 24.0   # reads+writes of ~d-wide tensors per layer (fwd+bwd)
ACT_RW_FWD = 8.0


def _resolve_attn_impl(cfg: ModelConfig, S: int, T: int, override: str) -> str:
    """Mirror repro_torch.models.attention's auto dispatch."""
    impl = override or cfg.attention_impl
    if impl == "auto":
        from repro_torch.models.attention import _CHUNK_THRESHOLD

        impl = "chunked" if S * T > _CHUNK_THRESHOLD else "reference"
    return impl


def bytes_for(cfg: ModelConfig, shape: ShapeConfig, n_params: float, *,
              attention_impl: str = "",
              optimizer: str = "adamw") -> float:
    """Total program HBM bytes for one step (all chips combined)."""
    S, B = shape.seq_len, shape.global_batch
    attention_impl = _resolve_attn_impl(cfg, S, S, attention_impl)
    wb = 2.0 if cfg.param_dtype == "bfloat16" else 4.0
    ab = 2.0 if cfg.dtype == "bfloat16" else 4.0
    d = cfg.d_model
    L = cfg.num_layers
    hd = cfg.resolved_head_dim

    if shape.kind == "train":
        tokens = float(S * B)
        # params: fwd read + remat refwd read + bwd read; grads f32 w+r;
        # optimizer state r+w (adam 2 moments, adafactor ~0) + update
        opt = 16.0 if optimizer == "adamw" else 2.0
        param_traffic = n_params * (3 * wb + 8.0 + opt + wb)
        act = tokens * d * ab * ACT_RW_FACTOR * L
        attn_quad = 0.0
        if cfg.family not in ("xlstm",):
            n_attn = L if cfg.family != "zamba" else -(-L // cfg.zamba_shared_period)
            if attention_impl == "reference":
                # materialised (S x S) scores+probs f32: ~3 accesses each
                attn_quad = 6.0 * B * cfg.num_heads * S * S * 4.0 * n_attn
        moe_traffic = 0.0
        if cfg.moe.num_experts:
            cap = moe_rows_per_token(cfg.moe, cfg.moe.group_size)
            per_tok = (2 * cap * d * ab                      # dispatch+return buffers
                       + 2 * cap * cfg.moe.num_experts * 0)  # combine fused
            combine = 2.0 * cap * cfg.moe.group_size * ab    # (T,E,C) r+w per token
            moe_traffic = tokens * (per_tok + combine) * L * 3.0
        return param_traffic + act + attn_quad + moe_traffic

    if shape.kind == "prefill":
        tokens = float(S * B)
        param_traffic = n_params * wb
        act = tokens * d * ab * ACT_RW_FWD * L
        attn_quad = 0.0
        if cfg.family not in ("xlstm",) and attention_impl == "reference":
            n_attn = L if cfg.family != "zamba" else -(-L // cfg.zamba_shared_period)
            attn_quad = 3.0 * B * cfg.num_heads * S * S * 4.0 * n_attn
        cache_write = 2.0 * B * S * cfg.num_kv_heads * hd * ab * L
        return param_traffic + act + attn_quad + cache_write

    # decode: weights + full KV cache (or recurrent state) read per step
    param_traffic = n_params * wb
    if cfg.moe.num_experts:  # only active experts' weights are touched
        frac = min(1.0, cfg.moe.active_k * B / cfg.moe.num_experts + 0.2)
        param_traffic = n_params * wb * frac
    if cfg.family == "xlstm":
        d_in = cfg.ssm_expand * d
        state = B * (cfg.num_heads * (d_in // cfg.num_heads) ** 2 + 3 * d_in) * 4.0 * L
        cache_traffic = 2.0 * state
    elif cfg.family == "zamba":
        H = cfg.ssm_heads or 1
        P = (cfg.ssm_expand * d) // H
        state = B * H * P * cfg.ssm_state * 4.0 * L * 2.0
        n_shared = -(-L // cfg.zamba_shared_period)
        kvc = 2.0 * B * S * cfg.num_kv_heads * (2 * d // cfg.num_heads) * ab * n_shared
        cache_traffic = state + kvc
    elif cfg.family == "encdec":
        kvc = 2.0 * B * S * cfg.num_kv_heads * hd * ab * L * 2  # self + cross
        cache_traffic = kvc
    else:
        cache_traffic = 2.0 * B * S * cfg.num_kv_heads * hd * ab * L
    act = float(B) * d * ab * ACT_RW_FWD * L
    return param_traffic + cache_traffic + act
