"""Per-family model API (``repro.models.registry``): every family of the
reference, the decoder LM, the two that add prefix embeddings to it (vlm,
m6), xLSTM, zamba and encdec:

  forward(params, batch, cfg, ctx)             training forward; logits
                                               align with batch["labels"]
                                               (encdec reads batch["frames"]
                                               and batch["tokens"])
  init_state(cfg, batch, max_len, device)      empty dense KV caches, the
                                               recurrent family's O(1)
                                               zero state (max_len ignored),
                                               or zamba's Mamba2 states
                                               and shared-attention caches;
                                               encdec refuses (its state
                                               needs the encoder's memory:
                                               ``encdec.init_state``)
  decode(params, tokens, state, cfg, ctx)      one-token serve step
  prefill(params, batch, cfg, max_len, ctx,    prompt -> (logits, state),
          state=None)                          filling ``state`` (empty
                                               caches) where given; None
                                               for xLSTM, zamba and encdec
  input_specs(cfg, shape)                      the train / prefill batch
                                               of a ShapeConfig, as meta
                                               tensors (the dry run's)
  decode_input_specs(cfg, shape)               {"tokens", "state"}: one
                                               token a row and the state at
                                               seq_len, as meta tensors
  kv_cache                                     the state holds caches of
                                               max_len positions

The static engine (``repro_torch.serving.engine``) serves through
``prefill`` and ``decode`` (``decode`` token by token over the prompt when
``prefill`` is None); the continuous engine runs its own paged forward for
the decoder LMs and ``decode`` in recurrent slots for xLSTM, and refuses
zamba and encdec, as the reference's does.  No engine serves encdec: the
static engine's ``generate`` fails at ``init_state`` with the reference's
message (the reference asserts; the port raises NotImplementedError), and
its decode route is ``encdec.encode``, ``encdec.init_state`` and
``decode`` (``encdec.decode_step``).  The families with no MoE layer
(xLSTM, zamba) take ``ctx`` and ignore it.  Under rules that shard the
model axis, ``init_state`` and the two ``*_input_specs`` give a rank's
state: its kv heads in every cache and cross K/V, its SSM heads and conv
channels in zamba's Mamba2 states (xLSTM's state is whole on every
rank)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models import xlstm as XL
from repro_torch.models import zamba as ZB
from repro_torch.models.attention import KVCache, local_kv_heads


@dataclasses.dataclass(frozen=True)
class FamilyAPI:
    forward: Callable     # (params, batch, cfg, ctx) -> (logits, aux)
    init_state: Callable  # (cfg, batch, max_len, device) -> state
    decode: Callable      # (params, tokens, state, cfg, ctx) -> (logits, state)
    prefill: Optional[Callable]  # (params, batch, cfg, max_len, ctx, state) -> (logits, state)
    input_specs: Callable        # (cfg, shape) -> the train / prefill batch on meta
    decode_input_specs: Callable  # (cfg, shape) -> {"tokens", "state"} on meta
    kv_cache: bool = True        # the state has max_len positions (a longer run is refused)


def _tokens(b: int, s: int) -> torch.Tensor:
    return torch.empty((b, s), dtype=torch.int32, device="meta")


def _token_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    return {"tokens": _tokens(shape.global_batch, shape.seq_len),
            "labels": _tokens(shape.global_batch, shape.seq_len)}


def _full(cache: KVCache, length: int) -> KVCache:
    """``cache`` at ``length`` (a 0-dim int32 tensor on its device)."""
    return KVCache(cache.k, cache.v, torch.full((), length, dtype=torch.int32,
                                                device=cache.k.device))


def _lm_forward(params, batch, cfg: ModelConfig, ctx=None):
    """Logits aligned with ``batch["labels"]``: the patch-embedding prefix
    goes in, and its logits are sliced off."""
    extra = batch.get("patch_embeds")
    logits, aux = TF.lm_apply(params, batch["tokens"], cfg, extra_embeds=extra, ctx=ctx)
    if extra is not None:
        logits = logits[:, extra.shape[1]:]
    return logits, aux


def _lm_prefill(params, batch, cfg: ModelConfig, max_len: int, ctx=None, state=None):
    logits, caches, _ = TF.prefill_apply(params, batch["tokens"], cfg, max_len=max_len,
                                         ctx=ctx, caches=state)
    return logits, caches


def _lm_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The batch of ``shape``: text after the image-token prefix, whose
    patch embeddings come in the activation dtype (vlm, m6)."""
    b, text = shape.global_batch, shape.seq_len - cfg.num_image_tokens
    specs = {"tokens": _tokens(b, text), "labels": _tokens(b, text)}
    if cfg.num_image_tokens:
        specs["patch_embeds"] = torch.empty((b, cfg.num_image_tokens, cfg.d_model),
                                            dtype=cfg.activation_dtype, device="meta")
    return specs


def _lm_decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """One token a row against caches of ``seq_len`` positions, all but the
    last one filled (the step attends over the whole cache)."""
    b = shape.global_batch
    caches = TF.init_caches(cfg, b, shape.seq_len, device="meta")
    return {"tokens": _tokens(b, 1), "state": _full(caches, shape.seq_len - 1)}


DECODER_LM = FamilyAPI(forward=_lm_forward, init_state=TF.init_caches,
                       decode=TF.decode_apply, prefill=_lm_prefill,
                       input_specs=_lm_input_specs, decode_input_specs=_lm_decode_input_specs)


def _xl_forward(params, batch, cfg: ModelConfig, ctx=None):
    logits, aux, _ = XL.xlstm_apply(params, batch["tokens"], cfg)
    return logits, aux


def _xl_init_state(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return XL.xlstm_init_states(cfg, batch, device)


def _xl_decode(params, tokens, state, cfg: ModelConfig, ctx=None):
    logits, _, new_state = XL.xlstm_apply(params, tokens, cfg, states=state)
    return logits, new_state


XLSTM = FamilyAPI(forward=_xl_forward, init_state=_xl_init_state, decode=_xl_decode,
                  prefill=None, input_specs=_token_specs,
                  decode_input_specs=lambda cfg, shape: {
                      "tokens": _tokens(shape.global_batch, 1),
                      "state": XL.xlstm_init_states(cfg, shape.global_batch, "meta")},
                  kv_cache=False)


def _zb_forward(params, batch, cfg: ModelConfig, ctx=None):
    logits, aux, _ = ZB.zamba_apply(params, batch["tokens"], cfg)
    return logits, aux


def _zb_decode(params, tokens, state, cfg: ModelConfig, ctx=None):
    logits, _, new_state = ZB.zamba_apply(params, tokens, cfg, state=state)
    return logits, new_state


def _zb_decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    st = ZB.zamba_init_state(cfg, b, shape.seq_len, "meta")
    return {"tokens": _tokens(b, 1),
            "state": st._replace(attn=_full(st.attn, shape.seq_len - 1))}


ZAMBA = FamilyAPI(forward=_zb_forward, init_state=ZB.zamba_init_state, decode=_zb_decode,
                  prefill=None, input_specs=_token_specs,
                  decode_input_specs=_zb_decode_input_specs)


def _ed_forward(params, batch, cfg: ModelConfig, ctx=None):
    return ED.encdec_train_apply(params, batch["frames"], batch["tokens"], cfg, ctx=ctx)


def _ed_init_state(cfg: ModelConfig, batch: int, max_len: int, device=None):
    raise NotImplementedError("use encdec.init_state with real memory for concrete states")


def _ed_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Frames (stub frontend embeddings) of ``seq_len`` positions and as
    many target tokens, as the reference's."""
    b, s = shape.global_batch, shape.seq_len
    return {"frames": torch.empty((b, s, cfg.d_model), dtype=cfg.activation_dtype,
                                  device="meta"),
            **_token_specs(cfg, shape)}


def _ed_decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The reference's ``abstract_state`` at ``seq_len``: self caches of
    ``seq_len`` positions (all but the last filled) and cross K/V of a
    ``seq_len``-frame memory."""
    b, s = shape.global_batch, shape.seq_len
    caches = TF.init_caches(cfg, b, s, device="meta")
    kv = torch.empty((cfg.num_layers, b, s, local_kv_heads(cfg), cfg.resolved_head_dim),
                     dtype=cfg.activation_dtype, device="meta")
    return {"tokens": _tokens(b, 1), "state": ED.EncDecState(_full(caches, s - 1), kv, kv)}


ENCDEC = FamilyAPI(forward=_ed_forward, init_state=_ed_init_state, decode=ED.decode_step,
                   prefill=None, input_specs=_ed_input_specs,
                   decode_input_specs=_ed_decode_input_specs)
_FAMILIES = {"decoder_lm": DECODER_LM, "vlm": DECODER_LM, "m6": DECODER_LM, "xlstm": XLSTM,
             "zamba": ZAMBA, "encdec": ENCDEC}


def get_family(cfg: ModelConfig) -> FamilyAPI:
    try:
        return _FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(f"model family {cfg.family!r} is not ported; "
                                  f"ported: {sorted(_FAMILIES)}") from None
