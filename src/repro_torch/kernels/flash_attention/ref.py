"""Plain PyTorch versions of causal (or full) GQA attention.

``attention_ref`` (``repro.kernels.flash_attention.ref.attention_ref``):
scores in f32 with the reference's ``-inf`` causal mask.  The CPU path of
the wrapper and the yardstick every CUDA kernel is held to.

``attention_split_ref``: the tensor-core route's numerics, for the card's
checks and the tests: an online softmax in base 2 over KV tiles of 64 keys
with the finite ``-1e30`` mask, each tile's unnormalised probabilities
(relative to the running max) kept as bf16 hi + lo (about 16 bits) or as
bf16 alone before the f32 P V, their sum taken in f32, the output
``acc / max(l, 1e-30)`` rounded once.  The kernel differs from it only in
how its f32 sums are taken (order, the tensor cores' accumulation) and in
``exp2``'s last bits."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, D); k/v: (B, S, Hkv, D); Hq % Hkv == 0."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * (D ** -0.5)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def split_p(p: torch.Tensor, planes: int = 2) -> torch.Tensor:
    """f32 probabilities as the kernel feeds them to the tensor cores:
    bf16 hi, plus (planes = 2) bf16 lo = bf16(p - hi), summed back in f32."""
    hi = p.to(torch.bfloat16).float()
    return hi if planes == 1 else hi + (p - hi).to(torch.bfloat16).float()


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, planes: int = 2,
                        block_kv: int = 64) -> torch.Tensor:
    """As :func:`attention_ref`, with the tensor-core kernel's numerics
    (module docstring)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    x = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * (math.log2(math.e) / math.sqrt(D))
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        x = x.masked_fill(~mask, NEG_INF)
    vf = v.float()
    m = torch.full(x.shape[:-1], NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(x.shape[:-1] + (D,), device=q.device)
    for k0 in range(0, S, block_kv):
        xt = x[..., k0:k0 + block_kv]
        m_new = torch.maximum(m, xt.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(xt - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", split_p(p, planes), vf[:, k0:k0 + block_kv])
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)
