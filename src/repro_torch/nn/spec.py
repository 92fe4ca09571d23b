"""Parameter shape trees, random init and the JAX weights bridge.

:func:`lm_shapes` is the port of ``repro.models.transformer.lm_specs``:
a uniform stack (every layer the same kind) has its blocks stacked
``(L, ...)`` as the reference stacks them under ``scan_layers``; a mixed
dense/MoE stack (``moe_layer_period`` > 1) is the reference's list of
per-layer dicts.  :func:`model_shapes` picks the family's tree (the
xLSTM family's from ``repro_torch.models.xlstm``, zamba's from
``repro_torch.models.zamba``: its Mamba2 blocks stacked ``(L, ...)``
under ``mamba``, its one shared block under ``shared``; encdec's from
:func:`encdec_shapes`: ``encoder`` and ``decoder`` stacked, one embedding
table that also unembeds).  Each leaf is a
:class:`ParamShape`: its shape, the dtype the port keeps it in, and how it
is initialised.

Storage dtypes: the reference stores every parameter in
``cfg.param_dtype`` (f32) and casts the matmul weights and embedding
table to ``cfg.dtype`` at every use (``layers.py:70,76,120``,
``dispatch/base.py:64-66``, ``dropless.py:167-169``).  The port's code
casts at the same places, so it runs either of two trees:

* the training tree (``train=True``) keeps every leaf in
  ``cfg.param_dtype``, as the reference does: f32 masters, without which
  AdamW's small steps would vanish in bf16 rounding;
* the serving tree (the default) keeps the matmul weights and the
  embedding table in ``cfg.dtype`` once, so the values it multiplies with
  are identical and the cast at use is a no-op.

Norm scales/biases, the router and the learned ``pos_embed`` source are
f32 in both, as the reference computes with them.

Every family's leaves carry the reference's *logical axes*
(``ParamSpec.logical_axes``: "embed", "heads", "expert", "ssm_inner", ...
with "layers" leading a stacked leaf), which
``repro_torch.distributed.sharding`` maps to mesh axes.

Random init (:func:`init_params`) draws truncated normals (+-2 sigma,
times ``initializer_range``; ``nn.initializers.truncated_normal_init``)
from a ``torch.Generator``; it matches the
reference in distribution only — ``jax.random`` and ``torch`` give
different numbers for the same seed.  Tests that need identical weights
carry the reference's params across with :func:`from_jax_params`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core.routers import get_router
from repro_torch.nn.initializers import ones_init, truncated_normal_init, zeros_init


@dataclasses.dataclass(frozen=True)
class ParamShape:
    shape: Tuple[int, ...]
    dtype: str                  # "bfloat16" | "float32" ...
    init: str                   # "normal" (truncated) | "ones" | "zeros"
    axes: Optional[Tuple[Optional[str], ...]] = None    # logical axes, one a dim


def _lead_axes(lead: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
    return ("layers",) * len(lead)


def padded_vocab(vocab_size: int, multiple: int = 256) -> int:
    return -(-vocab_size // multiple) * multiple


def _norm(cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Dict[str, ParamShape]:
    d = cfg.d_model
    axes = _lead_axes(lead) + ("embed",)
    out = {"scale": ParamShape(lead + (d,), "float32", "ones", axes)}
    if cfg.norm == "layernorm":
        out["bias"] = ParamShape(lead + (d,), "float32", "zeros", axes)
    return out


def _dense(wdt: str, lead, d_in: int, d_out: int, bias: bool = False,
           axes: Tuple[str, str] = ("embed", "mlp")):
    la = _lead_axes(lead)
    out = {"kernel": ParamShape(lead + (d_in, d_out), wdt, "normal", la + axes)}
    if bias:
        out["bias"] = ParamShape(lead + (d_out,), "float32", "zeros", la + axes[1:])
    return out


def _attn(cfg: ModelConfig, wdt: str, lead: Tuple[int, ...]) -> Dict[str, ParamShape]:
    """Dense attention's leaves (``repro.models.attention.attention_specs``)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = {
        "wq": _dense(wdt, lead, d, cfg.num_heads * hd, cfg.qkv_bias, ("embed", "heads")),
        "wk": _dense(wdt, lead, d, cfg.num_kv_heads * hd, cfg.qkv_bias, ("embed", "kv_heads")),
        "wv": _dense(wdt, lead, d, cfg.num_kv_heads * hd, cfg.qkv_bias, ("embed", "kv_heads")),
        "wo": _dense(wdt, lead, cfg.num_heads * hd, d, axes=("heads", "embed")),
    }
    if cfg.qk_norm:
        attn["q_norm"] = ParamShape(lead + (hd,), "float32", "ones", _lead_axes(lead) + (None,))
        attn["k_norm"] = ParamShape(lead + (hd,), "float32", "ones", _lead_axes(lead) + (None,))
    return attn


def _block(cfg: ModelConfig, wdt: str, lead: Tuple[int, ...], moe_layer: bool) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    m = cfg.moe
    la = _lead_axes(lead)
    router = get_router(m.routing).weight_shape(m, d) if moe_layer else None
    # the routers' ParamSpecs: ("embed", "expert"), or ("embed", None,
    # "expert") for the prototype router's (d, P, E / P)
    router_axes = (None if router is None
                   else la + ("embed",) + (None,) * (len(router) - 2) + ("expert",))
    if m.moe_attention and moe_layer:       # core/moe_attention.py: per-expert projections
        E = m.num_experts

        def expert(shape, axes):
            return ParamShape(lead + shape, wdt, "normal", la + axes)

        attn = {"wq": expert((E, d, cfg.num_heads * hd), ("expert", "embed", "heads")),
                "wk": expert((E, d, cfg.num_kv_heads * hd), ("expert", "embed", "kv_heads")),
                "wv": expert((E, d, cfg.num_kv_heads * hd), ("expert", "embed", "kv_heads")),
                "wo": expert((E, cfg.num_heads * hd, d), ("expert", "heads", "embed"))}
        if router is not None:
            attn["router"] = ParamShape(lead + router, "float32", "normal", router_axes)
    else:
        attn = _attn(cfg, wdt, lead)
    gated = cfg.ffn_activation in ("swiglu", "geglu")
    if moe_layer:
        E = m.num_experts
        up_axes = la + ("expert", "embed", "mlp")
        ffn = {"up": ParamShape(lead + (E, d, cfg.d_ff), wdt, "normal", up_axes),
               "down": ParamShape(lead + (E, cfg.d_ff, d), wdt, "normal",
                                  la + ("expert", "mlp", "embed"))}
        if router is not None:          # the hash router has no weight
            ffn["router"] = ParamShape(lead + router, "float32", "normal", router_axes)
        if gated:
            ffn["gate"] = ParamShape(lead + (E, d, cfg.d_ff), wdt, "normal", up_axes)
    else:
        ffn = {"up": _dense(wdt, lead, d, cfg.d_ff),
               "down": _dense(wdt, lead, cfg.d_ff, d, axes=("mlp", "embed"))}
        if gated:
            ffn["gate"] = _dense(wdt, lead, d, cfg.d_ff)
    return {"ln_attn": _norm(cfg, lead), "ln_ffn": _norm(cfg, lead),
            "attn": attn, "ffn": ffn}


def is_moe_layer(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.moe.num_experts > 0 and layer_idx % cfg.moe_layer_period == 0


def lm_shapes(cfg: ModelConfig, train: bool = False) -> Dict:
    """Param shape tree, key for key the reference's ``lm_specs`` tree;
    ``train`` picks the training tree's storage (see module doc)."""
    wdt = cfg.param_dtype if train else cfg.dtype
    table = ParamShape((padded_vocab(cfg.vocab_size), cfg.d_model), wdt, "normal",
                       ("vocab", "embed"))
    uniform = cfg.moe.num_experts == 0 or cfg.moe_layer_period == 1
    if cfg.scan_layers and uniform:     # stacked (L, ...), as the reference decides
        blocks = _block(cfg, wdt, (cfg.num_layers,), is_moe_layer(cfg, 0))
    else:
        blocks = [_block(cfg, wdt, (), is_moe_layer(cfg, i)) for i in range(cfg.num_layers)]
    tree = {"embed": {"table": table}, "final_norm": _norm(cfg), "blocks": blocks}
    if cfg.pos_embed == "learned":
        tree["pos_embed"] = ParamShape((cfg.max_seq_len, cfg.d_model), "float32", "normal",
                                       (None, "embed"))
    if not cfg.tie_embeddings:
        tree["unembed"] = {"table": table}
    return tree


def encdec_shapes(cfg: ModelConfig, train: bool = False) -> Dict:
    """Param shape tree, key for key the reference's ``encdec_specs``: the
    dense encoder blocks stacked ``(L_enc, ...)`` (``num_encoder_layers``,
    or ``num_layers`` where that is 0), the decoder blocks stacked
    ``(L, ...)`` with self-attention, cross-attention and an FFN that is MoE
    in every layer where ``num_experts`` > 0 (dense attention in both, even
    under ``moe_attention``); one embedding table, which also unembeds,
    whatever ``tie_embeddings`` says, and no position table."""
    wdt = cfg.param_dtype if train else cfg.dtype
    n_enc = cfg.num_encoder_layers or cfg.num_layers
    lead = (cfg.num_layers,)
    dec = _block(cfg, wdt, lead, moe_layer=cfg.moe.num_experts > 0)
    decoder = {"ln_self": _norm(cfg, lead), "self_attn": _attn(cfg, wdt, lead),
               "ln_cross": _norm(cfg, lead), "cross_attn": _attn(cfg, wdt, lead),
               "ln_ffn": dec["ln_ffn"], "ffn": dec["ffn"]}
    return {"embed": {"table": ParamShape((padded_vocab(cfg.vocab_size), cfg.d_model), wdt,
                                          "normal", ("vocab", "embed"))},
            "encoder": _block(cfg, wdt, (n_enc,), moe_layer=False),
            "enc_norm": _norm(cfg), "decoder": decoder, "final_norm": _norm(cfg)}


def model_shapes(cfg: ModelConfig, train: bool = False) -> Dict:
    """The param shape tree of ``cfg``'s family."""
    if cfg.family == "encdec":
        return encdec_shapes(cfg, train)
    if cfg.family == "xlstm":
        from repro_torch.models.xlstm import xlstm_shapes

        return xlstm_shapes(cfg, train)
    if cfg.family == "zamba":
        from repro_torch.models.zamba import zamba_shapes

        return zamba_shapes(cfg, train)
    return lm_shapes(cfg, train)


def _map(fn, tree, path=()):
    if isinstance(tree, ParamShape):
        return fn(path, tree)
    if isinstance(tree, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}


def flat_params(tree, prefix: str = "") -> Dict:
    """The leaves of a param (or shape) tree by "/"-joined path, in the
    reference's tree-leaf order (dict keys sorted, list entries by index; an
    index is its digits in the path, ``"blocks/0/ffn/up"``); the leaves
    themselves, not copies."""
    if isinstance(tree, list):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        items = [(k, tree[k]) for k in sorted(tree)]
    out = {}
    for k, v in items:
        path = f"{prefix}{k}"
        out.update(flat_params(v, path + "/") if isinstance(v, (Mapping, list))
                   else {path: v})
    return out


def count_params(cfg: ModelConfig) -> int:
    total = []
    _map(lambda p, s: total.append(int(np.prod(s.shape))), model_shapes(cfg))
    return sum(total)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", train: bool = False,
                place: Optional[Callable] = None) -> Dict:
    """Random params from a ``torch.Generator`` on ``device`` (see module
    doc); ``train=True`` builds the training tree.  ``place(path, shape,
    leaf)`` (``repro_torch.distributed.sharding.placement``) keeps a mesh
    rank's slice of each leaf as it is drawn: the values are those of the
    whole tree, and no more than one whole leaf is held at a time."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    inits = {"ones": ones_init, "zeros": zeros_init,
             "normal": truncated_normal_init(cfg.initializer_range)}

    def one(path, s: ParamShape):
        t = inits[s.init](gen, s.shape, torch_dtype(s.dtype), device)
        return t if place is None else place(path, s, t)

    return _map(one, model_shapes(cfg, train))


def abstract(cfg: ModelConfig, train: bool = False, place: Optional[Callable] = None) -> Dict:
    """The param tree as ``meta`` tensors of its shapes and storage dtypes
    (``repro.nn.abstract``): what the dry run traces, with no storage;
    ``place`` as :func:`init_params`' (a mesh rank's blocks)."""
    def one(path, s: ParamShape):
        t = torch.empty(s.shape, dtype=torch_dtype(s.dtype), device="meta")
        return t if place is None else place(path, s, t)

    return _map(one, model_shapes(cfg, train))


def from_jax_params(tree: Mapping, cfg: ModelConfig, device="cuda", train: bool = False) -> Dict:
    """The reference's params (``jax.device_get`` -> numpy leaves) as the
    port's tensors, leaf for leaf, each cast to the storage dtype of the
    serving tree or (``train=True``) the training tree."""
    device = torch.device(device)

    def one(path, s: ParamShape):
        node = tree
        for k in path:
            node = node[k]
        a = np.array(node, dtype=np.float32)      # a writable copy
        if tuple(a.shape) != tuple(s.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: shape {a.shape}, "
                             f"expected {s.shape}")
        return torch.from_numpy(a).to(device=device, dtype=torch_dtype(s.dtype))

    return _map(one, model_shapes(cfg, train))
