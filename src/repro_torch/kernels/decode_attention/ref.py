"""Plain PyTorch versions of decode attention
(``repro.kernels.decode_attention.ref``): paged, quantized paged and dense.
The CPU path of the wrappers and what the CUDA kernels are held to; the
``*_split_ref`` versions compute the kernels' split over a thread-block
cluster and its merge."""
from __future__ import annotations

import torch

NEG_INF = -1e30  # finite mask: rows with length 0 must not produce NaN


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, block_tables: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """q: (N, Hq, D); pools (P, Hkv, bs, D); block_tables (N, MB);
    lengths (N,) (0 => masked row, output exactly 0).  Returns (N, Hq, D)."""
    N, Hq, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    G = Hq // Hkv
    tbl = block_tables.long()
    k = k_pool[tbl].permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    v = v_pool[tbl].permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    qg = q.reshape(N, Hkv, G, D).float()
    scores = torch.einsum("nkgd,nktd->nkgt", qg, k.float()) * (D ** -0.5)
    valid = torch.arange(MB * bs, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("nkgt,nktd->nkgd", probs, v.float())
    out = torch.where((lengths > 0)[:, None, None, None], out, torch.zeros_like(out))
    return out.reshape(N, Hq, D).to(q.dtype)


def quantized_paged_decode_attention_ref(q, k_pool, v_pool, k_scales, v_scales,
                                         block_tables, lengths, *, policy):
    """:func:`paged_decode_attention_ref` over int8 code pools: the gathered
    tiles are dequantized, ``policy.decode(code) * scale`` with the
    (P, Hkv) float32 scales keyed by the same block ids, then attended in f32
    (``repro.kernels.decode_attention.ref.quantized_paged_decode_attention_ref``)."""
    N, Hq, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    G = Hq // Hkv
    tbl = block_tables.long()
    k = policy.decode(k_pool[tbl]) * k_scales[tbl][..., None, None]   # (N, MB, Hkv, bs, D)
    v = policy.decode(v_pool[tbl]) * v_scales[tbl][..., None, None]
    k = k.permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    v = v.permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    qg = q.reshape(N, Hkv, G, D).float()
    scores = torch.einsum("nkgd,nktd->nkgt", qg, k) * (D ** -0.5)
    valid = torch.arange(MB * bs, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("nkgt,nktd->nkgd", probs, v)
    out = torch.where((lengths > 0)[:, None, None, None], out, torch.zeros_like(out))
    return out.reshape(N, Hq, D).to(q.dtype)


def _cap(scores: torch.Tensor, softcap: float) -> torch.Tensor:
    """The reference ``_sdpa``'s logit softcap, c tanh(s / c), where c > 0."""
    return torch.tanh(scores / softcap) * softcap if softcap > 0 else scores


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """Single-token GQA decode over a dense cache: q (B, Hq, D); k/v
    (B, T, Hkv, D); lengths (B,).  Returns (B, Hq, D).  ``softcap`` c > 0
    caps each score at c tanh(s / c) before the mask, as the reference's
    ``_sdpa`` does.

    The reference's ``decode_attention_ref`` masks with -inf, so a length-0
    row comes out NaN there, while its kernel gives exactly 0 (l = 0, so
    acc / max(l, 1e-30) = 0).  This version follows the kernel: a finite
    NEG_INF mask and length-0 rows exactly 0."""
    B, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    scores = _cap(torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * (D ** -0.5), softcap)
    valid = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v.float())
    out = torch.where((lengths > 0)[:, None, None, None], out, torch.zeros_like(out))
    return out.reshape(B, Hq, D).to(q.dtype)


def _split_merge(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
                 bs: int, splits: int, softcap: float = 0.0) -> torch.Tensor:
    """Attention of qg (N, Hkv, G, D) over the gathered f32 context k/v
    (N, Hkv, T, D) in tiles of ``bs`` positions, computed as the kernels'
    cluster computes it: split r takes the row's tiles r, r + splits,
    r + 2 splits, ... and reduces its live positions to (m, l, acc)
    (m = -1e30, l = acc = 0 when it has none); the states merge in split
    order,
    ``out = sum_r acc_r e^(m_r - M) / max(sum_r l_r e^(m_r - M), 1e-30)``
    with M the largest m_r, so a length-0 row comes out exactly 0; every
    split sees the scores capped by ``softcap`` (c > 0)."""
    N, Hkv, T, D = k.shape
    scores = _cap(torch.einsum("nkgd,nktd->nkgt", qg, k) * (D ** -0.5), softcap)
    pos = torch.arange(T, device=k.device)
    valid = pos[None, :] < lengths[:, None]                         # (N, T)
    states = []
    for r in range(splits):
        mine = (valid & ((pos // bs) % splits == r)[None, :])[:, None, None, :]
        s = torch.where(mine, scores, torch.full_like(scores, NEG_INF))
        m = s.amax(dim=-1)                                          # (N, Hkv, G)
        p = torch.where(mine, torch.exp(s - m[..., None]), torch.zeros_like(s))
        states.append((m, p.sum(dim=-1), torch.einsum("nkgt,nktd->nkgd", p, v)))
    top = torch.stack([m for m, _, _ in states]).amax(dim=0)
    l_sum = sum(l * torch.exp(m - top) for m, l, _ in states)
    acc = sum(a * torch.exp(m - top)[..., None] for m, _, a in states)
    return acc / torch.clamp(l_sum, min=1e-30)[..., None]


def decode_attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               lengths: torch.Tensor, splits: int,
                               tile_rows: int = 16, softcap: float = 0.0) -> torch.Tensor:
    """:func:`decode_attention_ref` computed through the dense kernel's
    split over ``splits`` CTAs and their merge (``_split_merge``), over
    tiles of ``tile_rows`` positions (``ops.DENSE_TILE_ROWS``); positions
    past T do not exist, those past a length are not weighted; ``softcap``
    as :func:`decode_attention_ref`'s."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    kk = k.permute(0, 2, 1, 3).float()                      # (B, Hkv, T, D)
    vv = v.permute(0, 2, 1, 3).float()
    out = _split_merge(q.reshape(B, Hkv, Hq // Hkv, D).float(), kk, vv, lengths, tile_rows,
                       splits, softcap)
    return out.reshape(B, Hq, D).to(q.dtype)


def paged_decode_attention_split_ref(q, k_pool, v_pool, block_tables, lengths,
                                     splits: int) -> torch.Tensor:
    """:func:`paged_decode_attention_ref` computed through the kernel's
    split over ``splits`` CTAs and their merge (``_split_merge``)."""
    N, Hq, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    tbl = block_tables.long()
    k = k_pool[tbl].permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D).float()
    v = v_pool[tbl].permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D).float()
    out = _split_merge(q.reshape(N, Hkv, Hq // Hkv, D).float(), k, v, lengths, bs, splits)
    return out.reshape(N, Hq, D).to(q.dtype)


def quantized_paged_decode_attention_split_ref(q, k_pool, v_pool, k_scales, v_scales,
                                               block_tables, lengths, splits: int, *,
                                               policy) -> torch.Tensor:
    """:func:`quantized_paged_decode_attention_ref` computed through the
    kernel's split over ``splits`` CTAs and their merge."""
    N, Hq, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    tbl = block_tables.long()
    k = policy.decode(k_pool[tbl]) * k_scales[tbl][..., None, None]
    v = policy.decode(v_pool[tbl]) * v_scales[tbl][..., None, None]
    k = k.permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    v = v.permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    out = _split_merge(q.reshape(N, Hkv, Hq // Hkv, D).float(), k, v, lengths, bs, splits)
    return out.reshape(N, Hq, D).to(q.dtype)
