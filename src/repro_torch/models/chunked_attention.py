"""Chunked online-softmax attention with a flash-style backward
(``repro.models.chunked_attention``).

The reference computes it in XLA (a ``lax.scan`` over KV blocks under a
``custom_vjp``), not in Pallas, so the port writes the same arithmetic in
PyTorch ops: no kernel replaces it.

Memory is O(S * block) instead of O(S * T): the forward walks the KV
blocks with a running (max, denominator, accumulator); the backward saves
only (q, k, v, out, lse) and recomputes each block's probabilities, with
dq summed over the blocks and dk/dv written block by block.

Layout: grouped-query form q (B, S, Hkv, G, D); k/v (B, T, Hkv, D).
``offset`` is the first query's position (the cache length on the KV
cache path); it is a Python int or a 0-dim integer tensor.
"""
from __future__ import annotations

from typing import Union

import torch

NEG_INF = -1e30


def _blocks(T: int, target: int) -> int:
    """The largest block of at most ``target`` positions that divides T."""
    b = min(target, T)
    while T % b:
        b -= 1
    return b


def _scores(q32, kb, softcap: float):
    # q32: (B,S,H,G,D) f32 pre-scaled; kb: (B,bkv,H,D) -> (B,H,G,S,bkv)
    s = torch.einsum("bshgd,bthd->bhgst", q32, kb)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    return s


def _rows(offset, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device) + (offset.to(device) if torch.is_tensor(offset)
                                             else offset)


def _kv_blocks(k, v, bkv: int):
    B, T, H, D = k.shape
    n = T // bkv
    return (k.float().reshape(B, n, bkv, H, D).unbind(1),
            v.float().reshape(B, n, bkv, H, D).unbind(1))


def _causal_mask(rows, idx: int, bkv: int):
    cols = idx * bkv + torch.arange(bkv, device=rows.device)
    return cols[None, :] <= rows[:, None]                          # (S, bkv)


def _forward(qg, k, v, causal: bool, offset, block: int, softcap: float):
    B, S, H, G, D = qg.shape
    T = k.shape[1]
    bkv = _blocks(T, block)
    q32 = qg.float() * (D ** -0.5)
    rows = _rows(offset, S, qg.device)
    m = torch.full((B, H, G, S), NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros((B, H, G, S), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, H, G, S, D), dtype=torch.float32, device=qg.device)
    for idx, (kblk, vblk) in enumerate(zip(*_kv_blocks(k, v, bkv))):
        s = _scores(q32, kblk, softcap)                            # (B,H,G,S,bkv)
        if causal:
            s = torch.where(_causal_mask(rows, idx, bkv), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgst,bthd->bhgsd", p, vblk)
        m = m_new
    l = l.clamp_min(1e-30)
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4)             # (B,S,H,G,D)
    lse = m + torch.log(l)                                         # (B,H,G,S)
    return out.to(qg.dtype), lse


def _backward(qg, k, v, out, lse, dout, causal: bool, offset, block: int, softcap: float):
    B, S, H, G, D = qg.shape
    T = k.shape[1]
    bkv = _blocks(T, block)
    scale = D ** -0.5
    q32 = qg.float() * scale
    do32 = dout.float()
    delta = (do32 * out.float()).sum(dim=-1).permute(0, 2, 3, 1)  # (B,H,G,S)
    rows = _rows(offset, S, qg.device)
    doh = do32.permute(0, 2, 3, 1, 4)                              # (B,H,G,S,D)
    dq = torch.zeros((B, S, H, G, D), dtype=torch.float32, device=qg.device)
    dks, dvs = [], []
    for idx, (kblk, vblk) in enumerate(zip(*_kv_blocks(k, v, bkv))):
        s = _scores(q32, kblk, 0.0)
        dcap = None
        if softcap > 0:
            t = torch.tanh(s / softcap)
            s = t * softcap
            dcap = 1.0 - t.square()                                # d(capped)/d(s)
        if causal:
            s = torch.where(_causal_mask(rows, idx, bkv), s, NEG_INF)
        p = torch.exp(s - lse[..., None])                          # (B,H,G,S,bkv)
        dvs.append(torch.einsum("bhgst,bhgsd->bthd", p, doh))
        dp = torch.einsum("bhgsd,bthd->bhgst", doh, vblk)
        ds = p * (dp - delta[..., None])
        if dcap is not None:
            ds = ds * dcap
        dq = dq + torch.einsum("bhgst,bthd->bshgd", ds, kblk) * scale
        dks.append(torch.einsum("bhgst,bshgd->bthd", ds, q32))
    dk = torch.cat(dks, dim=1)
    dv = torch.cat(dvs, dim=1)
    return dq.to(qg.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _ChunkedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qg, k, v, causal, offset, block, softcap):
        out, lse = _forward(qg, k, v, causal, offset, block, softcap)
        ctx.save_for_backward(qg, k, v, out, lse)
        ctx.args = (causal, offset, block, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        qg, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(qg, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def chunked_attention(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                      offset: Union[int, torch.Tensor] = 0, block: int = 512,
                      softcap: float = 0.0) -> torch.Tensor:
    """qg (B, S, Hkv, G, D), k/v (B, T, Hkv, D) -> (B, S, Hkv, G, D) in qg's
    dtype: softmax(q . k^T * D^-0.5 [softcapped], masked to t <= offset + s
    when ``causal``) v, over KV blocks of ``_blocks(T, block)`` positions.
    ``offset`` stands for both of the reference's ``q_offset_static`` and
    ``q_offset``."""
    return _ChunkedAttention.apply(qg, k, v, causal, offset, block, softcap)
