"""Per-family model API (``repro.models.registry``).  The port has the
decoder-LM family and the two that add prefix embeddings to it (vlm, m6):

  forward(params, batch, cfg, ctx)             training forward; logits
                                               align with batch["labels"]
  init_state(cfg, batch, max_len, device)      empty dense KV caches
  decode(params, tokens, state, cfg, ctx)      one-token serve step
  prefill(params, batch, cfg, max_len, ctx)    prompt -> (logits, state)

The static engine (``repro_torch.serving.engine``) serves through
``prefill`` and ``decode``; the continuous engine runs its own paged
forward."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF


@dataclasses.dataclass(frozen=True)
class FamilyAPI:
    forward: Callable     # (params, batch, cfg, ctx) -> (logits, aux)
    init_state: Callable  # (cfg, batch, max_len, device) -> state
    decode: Callable      # (params, tokens, state, cfg, ctx) -> (logits, state)
    prefill: Callable     # (params, batch, cfg, max_len, ctx) -> (logits, state)


def _lm_forward(params, batch, cfg: ModelConfig, ctx=None):
    """Logits aligned with ``batch["labels"]``: the patch-embedding prefix
    goes in, and its logits are sliced off."""
    extra = batch.get("patch_embeds")
    logits, aux = TF.lm_apply(params, batch["tokens"], cfg, extra_embeds=extra, ctx=ctx)
    if extra is not None:
        logits = logits[:, extra.shape[1]:]
    return logits, aux


def _lm_prefill(params, batch, cfg: ModelConfig, max_len: int, ctx=None):
    logits, caches, _ = TF.prefill_apply(params, batch["tokens"], cfg, max_len=max_len,
                                         ctx=ctx)
    return logits, caches


DECODER_LM = FamilyAPI(forward=_lm_forward, init_state=TF.init_caches,
                       decode=TF.decode_apply, prefill=_lm_prefill)
_FAMILIES = {"decoder_lm": DECODER_LM, "vlm": DECODER_LM, "m6": DECODER_LM}


def get_family(cfg: ModelConfig) -> FamilyAPI:
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(f"model family {cfg.family!r} is not ported; "
                                  f"ported: {sorted(_FAMILIES)}") from None
