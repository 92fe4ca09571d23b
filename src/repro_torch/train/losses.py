"""Causal-LM cross entropy plus the MoE auxiliary losses
(``repro.train.losses``).

On a training mesh (``distributed.sharding``'s rules active):

* where the vocab is sharded over the model axis, a rank's logits are its
  own vocab columns and the cross entropy is vocab-parallel: the global
  max, the global sum of exponentials and the label's logit from the rank
  that owns it, each all-reduced over the model axis;
* where the batch is sharded over the data axes, a rank's loss is its
  tokens' summed CE over the *global* token count, plus its share of the
  MoE terms (``core.moe`` scales them by 1/|DP|), so the ranks' losses sum
  to the reference's global loss and their gradients sum to its gradient;
  the metrics are the global ones (all-reduced over the data axes).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import active_rules, data_parallel, tensor_parallel
from repro_torch.nn.spec import padded_vocab


def _vocab_block(logits: torch.Tensor):
    tp = tensor_parallel("vocab")
    if tp is None or logits.shape[-1] == padded_vocab(active_rules().cfg.vocab_size):
        return None
    group, _, r = tp
    return group, r * logits.shape[-1]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token CE over labels >= 0 (negative labels are masked).
    logits: (B, S, V) over the padded vocab, whose padded entries were
    masked upstream.  Returns (loss, n_tokens); on a data-sharded mesh the
    loss is this rank's tokens' part of the mean over the global count."""
    valid = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    logits32 = logits.float()
    block = _vocab_block(logits)
    if block is None:
        logz = torch.logsumexp(logits32, dim=-1)
        gold = logits32.gather(-1, safe[..., None])[..., 0]
    else:
        group, lo = block
        top = collectives.all_reduce(logits32.detach().amax(dim=-1), group, op="max")
        sumexp = collectives.all_reduce((logits32 - top[..., None]).exp().sum(dim=-1), group)
        logz = sumexp.log() + top
        local = safe - lo
        inside = (local >= 0) & (local < logits.shape[-1])
        picked = logits32.gather(-1, torch.where(inside, local, torch.zeros_like(local))[..., None])
        gold = collectives.all_reduce(
            torch.where(inside, picked[..., 0], torch.zeros_like(picked[..., 0])), group)
    nll = (logz - gold) * valid
    count = valid.sum()
    dp = data_parallel()
    if dp is not None:
        count = collectives.all_reduce(count, dp[0])
    n = torch.clamp(count, min=1)
    return nll.sum() / n, n


def total_loss(logits, labels, aux: Dict) -> Tuple[torch.Tensor, Dict]:
    ce, n = cross_entropy(logits, labels)
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    aux_loss = aux.get("moe_aux_loss", zero)
    loss = ce + aux_loss + aux.get("moe_z_loss", zero)
    metrics = {"loss": loss, "ce": ce, "log_ppl": ce, "tokens": n, "moe_aux_loss": aux_loss}
    dp = data_parallel()
    if dp is not None:                      # the global values
        summed = collectives.all_reduce(
            torch.stack([loss.detach(), ce.detach(), aux_loss.detach()]), dp[0])
        metrics.update(loss=summed[0], ce=summed[1], log_ppl=summed[1], moe_aux_loss=summed[2])
    for k in ("moe_cv", "moe_dropped_fraction"):
        if k in aux:
            metrics[k] = aux[k]             # per-layer traces (L,)
    return loss, metrics
