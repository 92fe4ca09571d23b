"""Per-family model API (``repro.models.registry``).  The port has the
decoder-LM family and the two that add prefix embeddings to it (vlm, m6),
and of their API the training ``forward`` only; serving runs through
``repro_torch.serving``."""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF


@dataclasses.dataclass(frozen=True)
class FamilyAPI:
    forward: Callable     # (params, batch, cfg, ctx) -> (logits, aux)


def _lm_forward(params, batch, cfg: ModelConfig, ctx=None):
    """Logits aligned with ``batch["labels"]``: the patch-embedding prefix
    goes in, and its logits are sliced off."""
    extra = batch.get("patch_embeds")
    logits, aux = TF.lm_apply(params, batch["tokens"], cfg, extra_embeds=extra, ctx=ctx)
    if extra is not None:
        logits = logits[:, extra.shape[1]:]
    return logits, aux


DECODER_LM = FamilyAPI(forward=_lm_forward)
_FAMILIES = {"decoder_lm": DECODER_LM, "vlm": DECODER_LM, "m6": DECODER_LM}


def get_family(cfg: ModelConfig) -> FamilyAPI:
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(f"model family {cfg.family!r} is not ported; "
                                  f"ported: {sorted(_FAMILIES)}") from None
