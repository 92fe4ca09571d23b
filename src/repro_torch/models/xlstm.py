"""xLSTM blocks (arXiv:2405.04517; ``repro.models.xlstm``): mLSTM (matrix
memory, parallelisable) and sLSTM (scalar memory, recurrent); every
``cfg.xlstm_slstm_period``-th block is sLSTM (0: all mLSTM).

mLSTM runs the stabilised parallel (quadratic) form for training and
prompts, the chunkwise form when S > 2 * ``ssm_chunk`` (chunk
``max(ssm_chunk, 64)``), and an O(1) recurrent step at decode.  sLSTM is a
loop over time.  Gate math stays in float32.  No kernel runs here: the
reference computes all of it in XLA, outside Pallas, so plain PyTorch is
its port.

The three mLSTM forms start from the stabiliser m = 0 (the reference's
recurrent state and chunk carry), not -inf, so the denominator floor
``exp(-m)`` binds differently in each: each form is held to the
reference's own form (ROADMAP queue 3).  Maxima are ``amax`` and
``torch.maximum`` (never ``clamp``), whose gradients split among ties as
JAX's do: the sLSTM normaliser meets its floor of 1 exactly at a first
step whose input gate wins.

On a mesh, the leaves sit by the reference's partition specs, under which
only the vocab and the sLSTM FFN's "mlp" dim shard over the model axis:
the reference's rules map ``"ssm_inner"`` only for a config with an SSM
state, which xLSTM has not, so the mLSTM blocks and the sLSTM recurrence
are whole on every rank and every rank computes them alike.  The sLSTM
FFN is tensor-parallel: ``ffn_down`` row-parallel (a rank's block of the
``pf`` hidden units, one ``all_reduce``), and ``ffn_up``, whose columns
are u's ``pf`` and then the gate's, whole on every rank
(``sharding.HELD_WHOLE``; a block of it would give a rank u columns
without their gates): a rank reads its units' columns of each half,
through ``collectives.copy_to``, as it reads its FFN input.  Under FSDP
(``sharding.fsdp_gather``) each block gathers its leaves inside its remat
region, and the table and final norm are gathered once a call.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.metrics import empty_aux
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import fsdp_gather, tensor_parallel
from repro_torch.models import layers as L
from repro_torch.nn.spec import ParamShape, _norm, padded_vocab

_CONV_WIDTH = 4     # the reference's causal conv width (fixed)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    c: torch.Tensor     # (B, H, D, D) matrix memory
    n: torch.Tensor     # (B, H, D) normaliser
    m: torch.Tensor     # (B, H) stabiliser
    conv: torch.Tensor  # (B, W-1, D_inner) conv tail


class SLSTMState(NamedTuple):
    c: torch.Tensor     # (B, d)
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


def _mlstm_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model if cfg.ssm_expand else 2 * cfg.d_model
    return d_inner, cfg.num_heads, d_inner // cfg.num_heads


def _slstm_ffn(d: int) -> int:
    return int(d * 4 / 3) // 8 * 8 or 8      # the gated FFN's 4/3 projection


def _mlstm_shapes(cfg: ModelConfig, wdt: str):
    d = cfg.d_model
    di, H, _ = _mlstm_dims(cfg)

    def w(*shape, axes, dtype=wdt, init="normal"):
        return ParamShape(shape, dtype, init, axes)

    inner_in, inner_out = ("embed", "ssm_inner"), ("ssm_inner", None)
    return {"ln": _norm(cfg), "up_x": w(d, di, axes=inner_in), "up_z": w(d, di, axes=inner_in),
            "conv_w": w(_CONV_WIDTH, di, axes=(None, "ssm_inner")),
            "wq": w(di, di, axes=inner_out), "wk": w(di, di, axes=inner_out),
            "wv": w(di, di, axes=inner_out),
            "w_igate": w(di, H, axes=inner_out, dtype="float32"),
            "w_fgate": w(di, H, axes=inner_out, dtype="float32"),
            "b_igate": w(H, axes=(None,), dtype="float32", init="zeros"),
            "b_fgate": w(H, axes=(None,), dtype="float32", init="ones"),
            "head_norm": w(di, axes=("ssm_inner",), dtype="float32", init="ones"),
            "down": w(di, d, axes=("ssm_inner", "embed"))}


def _slstm_shapes(cfg: ModelConfig, wdt: str):
    d, H = cfg.d_model, cfg.num_heads
    dh, pf = d // H, _slstm_ffn(d)
    # the gates multiply in f32 (the reference casts w_gates and r_gates to
    # f32 at use), so both trees keep them in f32
    return {"ln": _norm(cfg),
            "w_gates": ParamShape((d, 4 * d), "float32", "normal", ("embed", None)),
            "r_gates": ParamShape((H, dh, 4 * dh), "float32", "normal", (None, None, None)),
            "b_gates": ParamShape((4 * d,), "float32", "zeros", (None,)),
            "head_norm": ParamShape((d,), "float32", "ones", ("embed",)),
            "ln_ffn": _norm(cfg),
            "ffn_up": ParamShape((d, 2 * pf), wdt, "normal", ("embed", "mlp")),
            "ffn_down": ParamShape((pf, d), wdt, "normal", ("mlp", "embed"))}


def _is_slstm(cfg: ModelConfig, i: int) -> bool:
    p = cfg.xlstm_slstm_period
    return p > 0 and i % p == p - 1


def xlstm_shapes(cfg: ModelConfig, train: bool = False):
    """Param shape tree, key for key the reference's ``xlstm_specs``
    (storage dtypes as ``nn.spec``'s module doc sets out)."""
    wdt = cfg.param_dtype if train else cfg.dtype
    table = ParamShape((padded_vocab(cfg.vocab_size), cfg.d_model), wdt, "normal",
                       ("vocab", "embed"))
    return {"embed": {"table": table}, "final_norm": _norm(cfg),
            "blocks": [_slstm_shapes(cfg, wdt) if _is_slstm(cfg, i) else _mlstm_shapes(cfg, wdt)
                       for i in range(cfg.num_layers)]}


def _causal_conv(x, w, tail=None):
    """x: (B, S, D), w: (W, D) depthwise causal conv; tail: (B, W-1, D)
    history.  Returns (out, new tail).  As in the reference, a decode
    step's f32 tail promotes the whole conv (and what follows it) to f32."""
    W = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([tail, x.to(torch.promote_types(tail.dtype, x.dtype))], dim=1)
    S = x.shape[1]
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[i][None, None, :].to(xp.dtype)
    new_tail = xp[:, -(W - 1):, :] if W > 1 else tail
    return out, new_tail


def _mlstm_parallel(q, k, v, igate, fgate):
    """Stabilised parallel mLSTM (paper App. B).  q, k, v: (B, H, S, D);
    igate/fgate: (B, H, S) pre-activations (f through log-sigmoid)."""
    S = q.shape[2]
    logf = F.logsigmoid(fgate)
    Fc = torch.cumsum(logf, dim=-1)
    Dmat = Fc[..., :, None] - Fc[..., None, :] + igate[..., None, :]
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    Dmat = torch.where(causal, Dmat, torch.full_like(Dmat, float("-inf")))
    m = torch.maximum(Dmat.amax(dim=-1, keepdim=True), Dmat.new_full((), -1e30))  # all -inf rows
    Dexp = torch.exp(Dmat - m)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhsd,bhtd->bhst", q, k) * scale * Dexp
    norm = torch.maximum(scores.sum(dim=-1, keepdim=True).abs(), torch.exp(-m))
    return torch.einsum("bhst,bhtd->bhsd", scores / norm, v)


def _mlstm_chunk(carry, qb, kb, vb, ib, fb, scale):
    """One chunk of the chunkwise form: (C, n, m) carry in, (carry, h) out."""
    C, n, m = carry
    W = qb.shape[2]
    logf = F.logsigmoid(fb)
    lF = torch.cumsum(logf, dim=-1)                                  # inclusive
    Dmat = lF[..., :, None] - lF[..., None, :] + ib[..., None, :]
    causal = torch.ones((W, W), dtype=torch.bool, device=qb.device).tril()
    Dmat = torch.where(causal, Dmat, torch.full_like(Dmat, float("-inf")))
    m_intra = Dmat.amax(dim=-1)
    m_inter = lF + m[..., None]
    m_t = torch.maximum(torch.maximum(m_intra, m_inter), m_intra.new_full((), -1e30))
    Dexp = torch.exp(Dmat - m_t[..., None])
    scores = torch.einsum("bhsd,bhtd->bhst", qb, kb) * scale * Dexp
    inter_w = torch.exp(m_inter - m_t)[..., None]
    num = torch.einsum("bhst,bhtd->bhsd", scores, vb) + \
        inter_w * torch.einsum("bhsd,bhde->bhse", qb * scale, C)
    den_intra = scores.sum(dim=-1)
    den_inter = torch.einsum("bhsd,bhd->bhs", qb * scale, n) * inter_w[..., 0]
    den = torch.maximum((den_intra + den_inter).abs(), torch.exp(-m_t))
    h = num / den[..., None]
    lF_W = lF[..., -1:]
    m_new = torch.maximum(lF_W[..., 0] + m, (lF_W - lF + ib).amax(dim=-1))
    kw = torch.exp(lF_W - lF + ib - m_new[..., None])
    decay = torch.exp(lF_W[..., 0] + m - m_new)
    C_new = decay[..., None, None] * C + torch.einsum("bhs,bhsd,bhse->bhde", kw, kb, vb)
    n_new = decay[..., None] * n + torch.einsum("bhs,bhsd->bhd", kw, kb)
    return (C_new, n_new, m_new), h


def _mlstm_chunked(q, k, v, igate, fgate, chunk: int = 256):
    """Chunkwise-parallel stabilised mLSTM, O(S * W) memory: q, k, v
    (B, H, S, D) f32; igate/fgate (B, H, S).  A sequence that is not a
    chunk multiple is padded with igate = -1e30 and fgate = 30, which add
    nothing, and the padded rows are sliced off."""
    B, H, S, D = q.shape
    W = min(chunk, S)
    if S % W:
        pad = W - S % W
        q, k, v = (F.pad(a, (0, 0, 0, pad)) for a in (q, k, v))
        igate = F.pad(igate, (0, pad), value=-1e30)
        fgate = F.pad(fgate, (0, pad), value=30.0)
    NC = q.shape[2] // W
    scale = D ** -0.5
    carry = (q.new_zeros((B, H, D, D)), q.new_zeros((B, H, D)), q.new_zeros((B, H)))
    hs = []
    for c in range(NC):
        sl = slice(c * W, (c + 1) * W)
        carry, h = _mlstm_chunk(carry, q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                igate[..., sl], fgate[..., sl], scale)
        hs.append(h)
    return torch.cat(hs, dim=2)[:, :, :S]


def _mlstm_step(q, k, v, ig, fg, state: MLSTMState, dh: int):
    """The O(1) recurrent step: q, k, v (B, H, D); ig/fg (B, H).
    Returns (h (B, H, D), c, n, m)."""
    q1 = q.float() * dh ** -0.5
    k1, v1 = k.float(), v.float()
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + state.m, ig)
    fprime = torch.exp(logf + state.m - m_new)[..., None]
    iprime = torch.exp(ig - m_new)[..., None]
    c_new = fprime[..., None] * state.c + iprime[..., None] * (k1[..., :, None] * v1[..., None, :])
    n_new = fprime * state.n + iprime * k1
    num = torch.einsum("bhd,bhde->bhe", q1, c_new)
    den = torch.maximum((q1 * n_new).sum(dim=-1, keepdim=True).abs(),
                        torch.exp(-m_new)[..., None])
    return num / den, c_new, n_new, m_new


def mlstm_block_apply(params, x, cfg: ModelConfig, *, state: Optional[MLSTMState] = None):
    """Returns (y, new_state); a state means a one-token decode step."""
    B, S, _ = x.shape
    d_inner, H, dh = _mlstm_dims(cfg)
    dt = x.dtype
    h = L.norm_apply(params["ln"], x, cfg)
    xb = h @ params["up_x"].to(dt)
    zb = h @ params["up_z"].to(dt)
    xc, new_tail = _causal_conv(xb, params["conv_w"].to(dt),
                                state.conv if state is not None else None)
    xc = F.silu(xc)
    q = (xc @ params["wq"].to(xc.dtype)).reshape(B, S, H, dh)
    k = (xc @ params["wk"].to(xc.dtype)).reshape(B, S, H, dh)
    v = (xb @ params["wv"].to(dt)).reshape(B, S, H, dh)
    ig = xc.float() @ params["w_igate"] + params["b_igate"]         # (B, S, H)
    fg = xc.float() @ params["w_fgate"] + params["b_fgate"]
    if state is None:
        qh, kh, vh = (a.transpose(1, 2).float() for a in (q, k, v))
        igh, fgh = ig.transpose(1, 2), fg.transpose(1, 2)
        if S > max(cfg.ssm_chunk, 1) * 2:
            hout = _mlstm_chunked(qh, kh, vh, igh, fgh, chunk=max(cfg.ssm_chunk, 64))
        else:
            hout = _mlstm_parallel(qh, kh, vh, igh, fgh)
        hout = hout.transpose(1, 2).reshape(B, S, d_inner)
        new_state = None
    else:
        h1, c, n, m = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0], state, dh)
        hout = h1.reshape(B, 1, d_inner)
        new_state = MLSTMState(c, n, m, new_tail)
    hout = L.head_rmsnorm_apply(params["head_norm"].reshape(H, dh),
                                hout.reshape(B, S, H, dh).float(), cfg.norm_eps)
    hout = hout.reshape(B, S, d_inner).to(dt)
    out = (hout * F.silu(zb)) @ params["down"].to(dt)
    return x + out, new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_cell(params, xt, state: SLSTMState, cfg: ModelConfig) -> SLSTMState:
    """One timestep, xt: (B, d) f32; block-diagonal recurrent gates (one
    (dh, 4 dh) block per head)."""
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    B = xt.shape[0]
    rec = torch.einsum("bhd,hde->bhe", state.h.reshape(B, H, dh), params["r_gates"].float())
    gates = (xt @ params["w_gates"].float()).reshape(B, H, 4 * dh) + rec + \
        params["b_gates"].reshape(H, 4 * dh)
    i_t, f_t, z_t, o_t = gates.split(dh, dim=-1)
    z = torch.tanh(z_t)
    o = torch.sigmoid(o_t)
    logf = F.logsigmoid(f_t)
    m_prev = state.m.reshape(B, H, dh)
    m_new = torch.maximum(logf + m_prev, i_t)
    iprime = torch.exp(i_t - m_new)
    fprime = torch.exp(logf + m_prev - m_new)
    c_new = fprime * state.c.reshape(B, H, dh) + iprime * z
    n_new = fprime * state.n.reshape(B, H, dh) + iprime
    h_new = o * c_new / torch.maximum(n_new, torch.ones_like(n_new))
    return SLSTMState(*(a.reshape(B, d) for a in (c_new, n_new, h_new, m_new)))


def slstm_block_apply(params, x, cfg: ModelConfig, *, state: Optional[SLSTMState] = None):
    """The time loop, then the GeGLU FFN (4/3 factor).  Returns (y,
    new_state or None)."""
    B, S, d = x.shape
    dt = x.dtype
    h = L.norm_apply(params["ln"], x, cfg).float()
    st = state if state is not None else slstm_init_state(cfg, B, x.device)
    hs = []
    for t in range(S):
        st = _slstm_cell(params, h[:, t], st, cfg)
        hs.append(st.h)
    hs = torch.stack(hs, dim=1)
    H = cfg.num_heads
    hs = L.head_rmsnorm_apply(params["head_norm"].reshape(H, d // H),
                              hs.reshape(B, S, H, -1), cfg.norm_eps)
    x = x + hs.reshape(B, S, d).to(dt)
    g = L.norm_apply(params["ln_ffn"], x, cfg)
    pf, up = _slstm_ffn(d), params["ffn_up"]
    tp = tensor_parallel("mlp")
    if tp is not None and params["ffn_down"].shape[0] != pf:
        group, n, r = tp
        g, up = collectives.copy_to(g, group), collectives.copy_to(up, group)
        lo, hi = r * pf // n, (r + 1) * pf // n
        up = torch.cat([up[:, lo:hi], up[:, pf + lo:pf + hi]], dim=1)
    else:
        tp = None
    u, gate = (g @ up.to(dt)).chunk(2, dim=-1)
    out = (F.gelu(gate, approximate="tanh") * u) @ params["ffn_down"].to(dt)
    if tp is not None:
        out = collectives.all_reduce(out, tp[0])
    return x + out, (st if state is not None else None)


def slstm_init_state(cfg: ModelConfig, batch: int, device=None) -> SLSTMState:
    return SLSTMState(*(torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
                        for _ in range(4)))


def mlstm_init_state(cfg: ModelConfig, batch: int, device=None) -> MLSTMState:
    d_inner, H, dh = _mlstm_dims(cfg)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return MLSTMState(z(batch, H, dh, dh), z(batch, H, dh), z(batch, H),
                      z(batch, _CONV_WIDTH - 1, d_inner))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def xlstm_apply(params, tokens, cfg: ModelConfig, *, states: Optional[List] = None):
    """tokens (B, S) -> (logits (B, S, V_pad), aux, new_states).  ``states``
    (one per block) means a decode step; without them each block is
    recomputed in the backward pass under ``cfg.remat``.  The unembedding
    is tied to the embedding table."""
    params = {**params, **fsdp_gather({k: v for k, v in params.items() if k != "blocks"})}
    x = L.embedding_apply(params["embed"], tokens, cfg)
    new_states = []
    for i, bp in enumerate(params["blocks"]):
        st = states[i] if states is not None else None
        fn = slstm_block_apply if _is_slstm(cfg, i) else mlstm_block_apply

        def block(p, h, st=None, f=fn, i=i):
            return f(fsdp_gather(p, f"blocks/{i}/"), h, cfg, state=st)

        if cfg.remat and states is None and torch.is_grad_enabled():
            x, ns = checkpoint(block, bp, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x, ns = block(bp, x, st)
        new_states.append(ns)
    x = L.norm_apply(params["final_norm"], x, cfg)
    logits = L.unembed_apply(params["embed"], x, cfg)
    return logits, empty_aux(device=x.device), (new_states if states is not None else None)


def xlstm_init_states(cfg: ModelConfig, batch: int, device=None) -> List:
    """Zeroed f32 states of every block (the stabiliser m included)."""
    return [slstm_init_state(cfg, batch, device) if _is_slstm(cfg, i)
            else mlstm_init_state(cfg, batch, device) for i in range(cfg.num_layers)]
