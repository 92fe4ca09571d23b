"""Per-family model API (``repro.models.registry``).  The port has the
decoder-LM family, the two that add prefix embeddings to it (vlm, m6),
xLSTM and zamba:

  forward(params, batch, cfg, ctx)             training forward; logits
                                               align with batch["labels"]
  init_state(cfg, batch, max_len, device)      empty dense KV caches, the
                                               recurrent family's O(1)
                                               zero state (max_len ignored),
                                               or zamba's Mamba2 states
                                               and shared-attention caches
  decode(params, tokens, state, cfg, ctx)      one-token serve step
  prefill(params, batch, cfg, max_len, ctx)    prompt -> (logits, state);
                                               None for xLSTM and zamba
  kv_cache                                     the state holds caches of
                                               max_len positions

The static engine (``repro_torch.serving.engine``) serves through
``prefill`` and ``decode`` (``decode`` token by token over the prompt when
``prefill`` is None); the continuous engine runs its own paged forward for
the decoder LMs and ``decode`` in recurrent slots for xLSTM, and refuses
zamba, as the reference's does.  The families with no MoE layer (xLSTM,
zamba) take ``ctx`` and ignore it.  The encdec family is not ported."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF
from repro_torch.models import xlstm as XL
from repro_torch.models import zamba as ZB


@dataclasses.dataclass(frozen=True)
class FamilyAPI:
    forward: Callable     # (params, batch, cfg, ctx) -> (logits, aux)
    init_state: Callable  # (cfg, batch, max_len, device) -> state
    decode: Callable      # (params, tokens, state, cfg, ctx) -> (logits, state)
    prefill: Optional[Callable]  # (params, batch, cfg, max_len, ctx) -> (logits, state)
    kv_cache: bool = True        # the state has max_len positions (a longer run is refused)


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


def _xl_forward(params, batch, cfg: ModelConfig, ctx=None):
    logits, aux, _ = XL.xlstm_apply(params, batch["tokens"], cfg)
    return logits, aux


def _xl_init_state(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return XL.xlstm_init_states(cfg, batch, device)


def _xl_decode(params, tokens, state, cfg: ModelConfig, ctx=None):
    logits, _, new_state = XL.xlstm_apply(params, tokens, cfg, states=state)
    return logits, new_state


XLSTM = FamilyAPI(forward=_xl_forward, init_state=_xl_init_state, decode=_xl_decode,
                  prefill=None, kv_cache=False)


def _zb_forward(params, batch, cfg: ModelConfig, ctx=None):
    logits, aux, _ = ZB.zamba_apply(params, batch["tokens"], cfg)
    return logits, aux


def _zb_decode(params, tokens, state, cfg: ModelConfig, ctx=None):
    logits, _, new_state = ZB.zamba_apply(params, tokens, cfg, state=state)
    return logits, new_state


ZAMBA = FamilyAPI(forward=_zb_forward, init_state=ZB.zamba_init_state, decode=_zb_decode,
                  prefill=None)
_FAMILIES = {"decoder_lm": DECODER_LM, "vlm": DECODER_LM, "m6": DECODER_LM, "xlstm": XLSTM,
             "zamba": ZAMBA}


def get_family(cfg: ModelConfig) -> FamilyAPI:
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(f"model family {cfg.family!r} is not ported; "
                                  f"ported: {sorted(_FAMILIES)}") from None
