"""Plain PyTorch version of causal (or full) GQA attention
(``repro.kernels.flash_attention.ref.attention_ref``), scores in f32 with
the reference's ``-inf`` causal mask.  The CPU path of the wrapper and the
yardstick the CUDA kernel is held to."""
from __future__ import annotations

import torch


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
