"""Draft-model drafter (``repro.serving.speculative.model``): a model
sharing the target's vocab proposes greedy continuations.

The draft model is a registered config (``SpecConfig.draft``) or an
explicit ``(cfg, params)`` pair.  A proposal is ``gamma`` full causal
forwards of static shape ``(max_slots, max_len)`` through the family's
``forward``: the slot contexts are right-padded into one token matrix and
each forward appends its argmax token at every slot's frontier.  Right
padding is invisible under causal attention, so the frontier logits are
exact for any mix of context lengths, and the drafter holds no per-slot
state.  The forwards run under ``torch.inference_mode`` with the plain
attention path (the reference's drafter never sets ``use_flash``); in an
MoE layer the dispatcher's expert FFN kernel runs over all
``max_slots * max_len`` rows.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.context import MoEContext
from repro_torch.models.registry import get_family
from repro_torch.serving.speculative import register_drafter
from repro_torch.serving.speculative.base import DraftItem

@register_drafter
class ModelDrafter:
    name = "model"

    def __init__(self, spec, target_cfg, serve, *, seed: int = 0,
                 draft_model: Optional[Tuple] = None, device="cuda"):
        if draft_model is not None:
            dcfg, dparams = draft_model
        else:
            if spec.draft is None:
                raise ValueError(
                    "the model drafter needs SpecConfig.draft (a registered config id) "
                    "or an explicit draft_model=(cfg, params)")
            from repro_torch.configs.registry import get_smoke_config

            dcfg = get_smoke_config(spec.draft)
            dparams = None
        if dcfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft model vocab {dcfg.vocab_size} != target vocab "
                f"{target_cfg.vocab_size}: speculative decoding verifies draft token "
                f"ids against target logits, the vocabs must be shared")
        W = serve.max_len
        if dcfg.max_seq_len < W:
            if dcfg.pos_embed == "learned":
                # the reference's gather clamps positions past the table
                # silently; the port refuses, as the engine does
                raise ValueError(f"serve max_len {W} exceeds the draft model's learned "
                                 f"position table ({dcfg.max_seq_len} positions)")
            dcfg = dcfg.replace(max_seq_len=W)
        self.fam = get_family(dcfg)
        if self.fam.prefill is None:
            raise ValueError(f"model drafter needs a full-forward (transformer-like) "
                             f"family, got {dcfg.family!r}")
        if dparams is None:
            from repro_torch.nn import init_params

            dparams = init_params(dcfg, seed=seed ^ 0x5BEC, device=device)
        self.cfg = dcfg
        self.params = dparams
        self.device = dparams["embed"]["table"].device
        self.gamma = spec.gamma
        self._S, self._W = serve.max_slots, W

    @torch.inference_mode()
    def _draft(self, tokens: torch.Tensor, ctx_len: torch.Tensor) -> torch.Tensor:
        """tokens (S, W) right-padded contexts, ctx_len (S,) valid lengths (0:
        an idle row) -> (S, gamma) greedy continuations."""
        W = self._W
        cols = torch.arange(W, device=tokens.device)[None, :]
        outs = []
        for i in range(self.gamma):
            logits, _ = self.fam.forward(self.params, {"tokens": tokens}, self.cfg,
                                         ctx=MoEContext())
            idx = (ctx_len + i - 1).clamp(0, W - 1)
            lg = logits[torch.arange(tokens.shape[0], device=tokens.device), idx].float()
            nxt = lg.argmax(dim=-1)                         # the first maximum
            outs.append(nxt)
            # append at the frontier; a column >= W matches nothing (budgets
            # are clamped so accepted tokens always fit; the host slices off
            # an over-long draft's tail)
            tokens = torch.where(cols == (ctx_len + i)[:, None], nxt[:, None], tokens)
        return torch.stack(outs, dim=1).to(torch.int32)

    def propose(self, items: List[DraftItem]) -> List[np.ndarray]:
        S, W = self._S, self._W
        host = np.zeros((S, W + 1), np.int64)       # the tokens, then the length
        for i, it in enumerate(items):
            c = np.asarray(it.context, np.int64).reshape(-1)[-W:]
            host[i, :c.size] = c
            host[i, W] = c.size
        dev = torch.from_numpy(host).to(self.device)
        out = self._draft(dev[:, :W], dev[:, W]).cpu().numpy()
        return [out[i, :it.max_tokens].astype(np.int32) for i, it in enumerate(items)]
