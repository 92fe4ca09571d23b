"""Parameter shape trees, random init and the JAX weights bridge.

:func:`lm_shapes` is the port of ``repro.models.transformer.lm_specs`` for
the uniform decoder (every layer the same kind), with the blocks stacked
``(L, ...)`` as the reference stacks them under ``scan_layers``.  Each
leaf is a :class:`ParamShape`: its shape, the dtype the port keeps it in,
and how it is initialised.

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

Random init (:func:`init_params`) draws truncated normals (+-2 sigma,
times ``initializer_range``) from a ``torch.Generator``; it matches the
reference in distribution only — ``jax.random`` and ``torch`` give
different numbers for the same seed.  Tests that need identical weights
carry the reference's params across with :func:`from_jax_params`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, torch_dtype


@dataclasses.dataclass(frozen=True)
class ParamShape:
    shape: Tuple[int, ...]
    dtype: str                  # "bfloat16" | "float32" ...
    init: str                   # "normal" (truncated) | "ones" | "zeros"


def padded_vocab(vocab_size: int, multiple: int = 256) -> int:
    return -(-vocab_size // multiple) * multiple


def _norm(cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Dict[str, ParamShape]:
    d = cfg.d_model
    out = {"scale": ParamShape(lead + (d,), "float32", "ones")}
    if cfg.norm == "layernorm":
        out["bias"] = ParamShape(lead + (d,), "float32", "zeros")
    return out


def _dense(wdt: str, lead, d_in: int, d_out: int, bias: bool = False):
    out = {"kernel": ParamShape(lead + (d_in, d_out), wdt, "normal")}
    if bias:
        out["bias"] = ParamShape(lead + (d_out,), "float32", "zeros")
    return out


def _block(cfg: ModelConfig, wdt: str, L: int) -> Dict:
    lead = (L,)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = {
        "wq": _dense(wdt, lead, d, cfg.num_heads * hd, cfg.qkv_bias),
        "wk": _dense(wdt, lead, d, cfg.num_kv_heads * hd, cfg.qkv_bias),
        "wv": _dense(wdt, lead, d, cfg.num_kv_heads * hd, cfg.qkv_bias),
        "wo": _dense(wdt, lead, cfg.num_heads * hd, d),
    }
    if cfg.qk_norm:
        attn["q_norm"] = ParamShape(lead + (hd,), "float32", "ones")
        attn["k_norm"] = ParamShape(lead + (hd,), "float32", "ones")
    gated = cfg.ffn_activation in ("swiglu", "geglu")
    m = cfg.moe
    if m.num_experts > 0:
        E = m.num_experts
        if m.routing == "topk":
            router = lead + (d, E)
        elif m.routing == "prototype":      # (d_model, Z, F), Fig. 8
            router = lead + (d, m.num_prototypes, m.experts_per_prototype)
        else:
            raise NotImplementedError(
                f"routing {m.routing!r} is not ported (topk and prototype only)")
        ffn = {"up": ParamShape(lead + (E, d, cfg.d_ff), wdt, "normal"),
               "down": ParamShape(lead + (E, cfg.d_ff, d), wdt, "normal"),
               "router": ParamShape(router, "float32", "normal")}
        if gated:
            ffn["gate"] = ParamShape(lead + (E, d, cfg.d_ff), wdt, "normal")
    else:
        ffn = {"up": _dense(wdt, lead, d, cfg.d_ff),
               "down": _dense(wdt, lead, cfg.d_ff, d)}
        if gated:
            ffn["gate"] = _dense(wdt, lead, d, cfg.d_ff)
    return {"ln_attn": _norm(cfg, lead), "ln_ffn": _norm(cfg, lead),
            "attn": attn, "ffn": ffn}


def lm_shapes(cfg: ModelConfig, train: bool = False) -> Dict:
    """Param shape tree, key for key the reference's ``lm_specs`` tree;
    ``train`` picks the training tree's storage (see module doc)."""
    if cfg.moe.num_experts > 0 and cfg.moe_layer_period != 1:
        raise NotImplementedError(
            "mixed dense/MoE layer stacks are not ported (moe_layer_period=1 only)")
    if cfg.moe.moe_attention:
        raise NotImplementedError("moe_attention is not ported")
    wdt = cfg.param_dtype if train else cfg.dtype
    table = ParamShape((padded_vocab(cfg.vocab_size), cfg.d_model), wdt, "normal")
    tree = {"embed": {"table": table}, "final_norm": _norm(cfg),
            "blocks": _block(cfg, wdt, cfg.num_layers)}
    if cfg.pos_embed == "learned":
        tree["pos_embed"] = ParamShape((cfg.max_seq_len, cfg.d_model), "float32", "normal")
    if not cfg.tie_embeddings:
        tree["unembed"] = {"table": table}
    return tree


def _map(fn, tree, path=()):
    if isinstance(tree, ParamShape):
        return fn(path, tree)
    return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}


def flat_params(tree: Mapping, prefix: str = "") -> Dict:
    """The leaves of a param (or shape) tree by "/"-joined path, keys in
    sorted order (the reference's tree-leaf order); the leaves themselves,
    not copies."""
    out = {}
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}{k}"
        out.update(flat_params(v, path + "/") if isinstance(v, Mapping) else {path: v})
    return out


def count_params(cfg: ModelConfig) -> int:
    total = []
    _map(lambda p, s: total.append(int(np.prod(s.shape))), lm_shapes(cfg))
    return sum(total)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", train: bool = False) -> Dict:
    """Random params from a ``torch.Generator`` on ``device`` (see module
    doc); ``train=True`` builds the training tree."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def one(path, s: ParamShape):
        dt = torch_dtype(s.dtype)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        t = torch.empty(s.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return t.mul_(cfg.initializer_range).to(dt)

    return _map(one, lm_shapes(cfg, train))


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
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, expected {s.shape}")
        return torch.from_numpy(a).to(device=device, dtype=torch_dtype(s.dtype))

    return _map(one, lm_shapes(cfg, train))
