"""Prompt-lookup (n-gram) self-drafting (``repro.serving.speculative.ngram``,
pure numpy).

The cheapest possible drafter: no parameters, no second model.  For
each speculating slot, find the most recent earlier occurrence of the
context's trailing n-gram (longest match first, ``n = max_ngram .. 1``)
and propose the tokens that followed it.  Generation that quotes or
extends its own prompt — code completion, summarisation, retrieval, and
(usefully for synthetic benchmarks) the repetition loops greedy
decoding falls into — gets near-free accepted tokens; novel text just
degrades to ordinary decoding, because a wrong draft costs one verify
row, never correctness.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.serving.speculative import register_drafter
from repro_torch.serving.speculative.base import DraftItem


def lookup_continuation(context: np.ndarray, max_tokens: int,
                        max_ngram: int) -> np.ndarray:
    """Longest-suffix prompt lookup over ``context``; returns up to
    ``max_tokens`` proposed continuation tokens (possibly empty)."""
    context = np.asarray(context).reshape(-1)
    L = context.size
    if max_tokens <= 0 or L < 2:
        return np.empty(0, np.int32)
    for n in range(min(max_ngram, L - 1), 0, -1):
        suffix = context[L - n:]
        windows = np.lib.stride_tricks.sliding_window_view(context, n)
        # candidate starts s <= L - n - 1: strictly earlier than the
        # suffix occurrence itself, so a continuation token exists
        matches = np.flatnonzero((windows[:L - n] == suffix).all(axis=1))
        if matches.size:
            # prefer the most recent match whose continuation can fill
            # the whole draft budget (a match near the context's end
            # would truncate the proposal to a token or two — fatal for
            # cyclic generations, where every period is a match); fall
            # back to the earliest, i.e. longest-continuation, match
            full = matches[matches + n + max_tokens <= L]
            s = int(full[-1]) if full.size else int(matches[0])
            return context[s + n: s + n + max_tokens].astype(np.int32)
    return np.empty(0, np.int32)


@register_drafter
class NgramDrafter:
    name = "ngram"

    def __init__(self, spec, target_cfg, serve, *, seed: int = 0,
                 draft_model=None, device="cuda"):
        del target_cfg, serve, seed, draft_model, device  # stateless, paramless
        self.max_ngram = spec.max_ngram

    def propose(self, items: List[DraftItem]) -> List[np.ndarray]:
        return [lookup_continuation(it.context, it.max_tokens, self.max_ngram)
                for it in items]
