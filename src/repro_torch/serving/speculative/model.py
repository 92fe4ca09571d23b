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

The reference jits the ``gamma`` forwards as one function; the port's are
one static form (``serving.graphs.GraphForm``) over an input buffer of
``(max_slots, max_len + 1)`` (each row's tokens, then its length), which
``propose`` fills from a host staging buffer (pinned on the card) with one
copy, and whose ``(max_slots, gamma)`` int32 proposals it reads once.
:meth:`ModelDrafter.capture` captures the form as a CUDA graph (the
continuous engine calls it on its graph pool when it captures its own
steps); uncaptured, a proposal runs the forwards eagerly.  The engine's
census of compiled variants counts its steps only, as the reference's
counts its ``_step_fn`` and ``_verify_fn``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.context import MoEContext
from repro_torch.models.registry import get_family
from repro_torch.serving.graphs import GraphForm
from repro_torch.serving.speculative import register_drafter
from repro_torch.serving.speculative.base import DraftItem

def _draft_fn(fam, cfg, params, gamma: int, W: int):
    """The ``gamma`` greedy forwards (the reference's ``draft_fn``):
    tokens (S, W) right-padded contexts, ctx_len (S,) valid lengths (0: an
    idle row) -> (S, gamma) int32 greedy continuations."""
    @torch.inference_mode()
    def draft(tokens: torch.Tensor, ctx_len: torch.Tensor) -> torch.Tensor:
        cols = torch.arange(W, device=tokens.device)[None, :]
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        outs = []
        for i in range(gamma):
            logits, _ = fam.forward(params, {"tokens": tokens}, cfg, ctx=MoEContext())
            idx = (ctx_len + i - 1).clamp(0, W - 1)
            nxt = logits[rows, idx].float().argmax(dim=-1)  # the first maximum
            outs.append(nxt)
            # append at the frontier; a column >= W matches nothing (budgets
            # are clamped so accepted tokens always fit; the host slices off
            # an over-long draft's tail)
            tokens = torch.where(cols == (ctx_len + i)[:, None], nxt[:, None], tokens)
        return torch.stack(outs, dim=1).to(torch.int32)

    return draft


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
        S, self._W = serve.max_slots, W
        self._host = torch.zeros((S, W + 1), dtype=torch.int64,
                                 pin_memory=self.device.type == "cuda")
        inputs = torch.zeros((S, W + 1), dtype=torch.int64, device=self.device)
        # the body holds no reference to the drafter (a dropped engine frees
        # its graphs without a collection)
        self._draft = draft = _draft_fn(self.fam, dcfg, dparams, self.gamma, W)
        self.form = GraphForm(lambda: draft(inputs[:, :W], inputs[:, W]),
                              f"the model drafter's {self.gamma} forwards ({S} x {W})", inputs)

    def capture(self, pool) -> None:
        """Capture the drafter's form as a CUDA graph on ``pool`` (its
        warm-up drafts from empty contexts)."""
        self.form.capture(self.device, pool)

    @property
    def graph_bytes(self) -> int:
        return self.form.graph_bytes

    def propose(self, items: List[DraftItem]) -> List[np.ndarray]:
        W = self._W
        host = self._host.numpy()                   # the tokens, then the length
        host.fill(0)
        for i, it in enumerate(items):
            c = np.asarray(it.context, np.int64).reshape(-1)[-W:]
            host[i, :c.size] = c
            host[i, W] = c.size
        # the read synchronizes: the next proposal's host writes come after
        # this one's copy
        out = self.form.run(self._host).cpu().numpy()
        return [out[i, :it.max_tokens].astype(np.int32) for i, it in enumerate(items)]
