"""Acceptance rules for speculative decoding
(``repro.serving.speculative.accept``, pure numpy, copied unchanged).

One verify step scores ``g + 1`` rows for a slot: row ``j`` holds the
target model's logits for the token *after* context position ``c + j``
(row 0 re-feeds the newest sampled token, rows ``1..g`` feed the draft).
Given the draft ``d[0..g-1]`` (``d[j]`` sits at position ``c + j + 1``
and was predicted by row ``j``):

* **Greedy** (temperature 0): accept the longest prefix with
  ``d[j] == argmax(row j)``; emit ``argmax(row 0..n)`` — the ``n``
  accepted drafts plus one bonus token.  Every emitted token is exactly
  the argmax the non-speculative engine would have produced at that
  position, so greedy speculative output is provably token-identical.
* **Rejection sampling** (temperature > 0, Leviathan et al. 2023 /
  Chen et al. 2023 specialised to deterministic drafts): with the
  draft treated as a point-mass proposal ``q = onehot(d[j])``, accept
  ``d[j]`` with probability ``p[d[j]]``; on rejection sample from the
  residual ``p`` with ``d[j]`` zeroed and renormalised; if every draft
  survives, sample the bonus token from the last row.  Marginally each
  emitted token is distributed exactly as ``p`` — the target
  distribution is preserved for *any* drafter.

Randomness is host-side and keyed per ``(engine seed, slot, absolute
position)`` (``numpy.random.default_rng`` over a ``SeedSequence``), so temperature > 0
acceptance is reproducible under slot reuse and independent across
slots — the same discipline the engine's on-device per-row sampling
keys follow.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np


def softmax_rows(logits: np.ndarray, temperature: float) -> np.ndarray:
    """Row-wise softmax of ``logits / temperature`` in float64 (host-side
    acceptance math should not add its own rounding to the comparison)."""
    z = logits.astype(np.float64) / float(temperature)
    z -= z.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


def accept_greedy_ids(draft: np.ndarray,
                      argmax_rows: np.ndarray) -> Tuple[List[int], int]:
    """Greedy acceptance from per-row argmax token ids (what the verify
    step ships at temperature 0 — (g+1,) int32s, not (g+1, V) logits).
    Returns (emitted tokens, number of accepted draft tokens)."""
    g = int(np.asarray(draft).size)
    n = 0
    while n < g and int(draft[n]) == int(argmax_rows[n]):
        n += 1
    return [int(argmax_rows[j]) for j in range(n + 1)], n


def accept_greedy(draft: np.ndarray,
                  logits_rows: np.ndarray) -> Tuple[List[int], int]:
    """Returns (emitted tokens, number of accepted draft tokens)."""
    return accept_greedy_ids(draft, np.argmax(logits_rows, axis=-1))


def accept_rejection(draft: np.ndarray, logits_rows: np.ndarray,
                     temperature: float,
                     rng_for_row: Callable[[int], np.random.Generator],
                     ) -> Tuple[List[int], int]:
    """Rejection-sampling acceptance against a point-mass draft.

    ``rng_for_row(j)`` yields the deterministic generator for row ``j``
    (absolute position ``c + j``); the accept test and any residual
    sample for that row both draw from it.
    """
    probs = softmax_rows(logits_rows, temperature)
    V = probs.shape[-1]
    emitted: List[int] = []
    g = int(np.asarray(draft).size)
    for j in range(g):
        d = int(draft[j])
        rng = rng_for_row(j)
        if rng.random() < probs[j, d]:
            emitted.append(d)
            continue
        residual = probs[j].copy()
        residual[d] = 0.0
        s = residual.sum()
        if s <= 0.0:
            # p was (numerically) a point mass on d; rejection of a
            # sure token is a float artifact — emit it
            emitted.append(d)
            continue
        emitted.append(int(rng.choice(V, p=residual / s)))
        return emitted, j
    rng = rng_for_row(g)
    emitted.append(int(rng.choice(V, p=probs[g])))
    return emitted, g
