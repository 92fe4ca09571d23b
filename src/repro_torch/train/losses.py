"""Causal-LM cross entropy plus the MoE auxiliary losses
(``repro.train.losses``)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token CE over labels >= 0 (negative labels are masked).
    logits: (B, S, V) over the padded vocab, whose padded entries were
    masked upstream.  Returns (loss, n_tokens)."""
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    gold = logits32.gather(-1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    n = torch.clamp(valid.sum(), min=1)
    return nll.sum() / n, n


def total_loss(logits, labels, aux: Dict) -> Tuple[torch.Tensor, Dict]:
    ce, n = cross_entropy(logits, labels)
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    loss = ce + aux.get("moe_aux_loss", zero) + aux.get("moe_z_loss", zero)
    metrics = {"loss": loss, "ce": ce, "log_ppl": ce, "tokens": n,
               "moe_aux_loss": aux.get("moe_aux_loss", zero)}
    for k in ("moe_cv", "moe_dropped_fraction"):
        if k in aux:
            metrics[k] = aux[k]             # per-layer traces (L,)
    return loss, metrics
