"""Plain PyTorch version of paged decode attention
(``repro.kernels.decode_attention.ref.paged_decode_attention_ref``).
The CPU path of the wrapper and the yardstick the CUDA kernel is held to."""
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
