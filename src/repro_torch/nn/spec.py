"""Parameter shape trees, random init and the JAX weights bridge.

:func:`lm_shapes` is the port of ``repro.models.transformer.lm_specs`` for
the uniform decoder (every layer the same kind), with the blocks stacked
``(L, ...)`` as the reference stacks them under ``scan_layers``.  Each
leaf is a :class:`ParamShape`: its shape, the dtype the port keeps it in,
and how it is initialised.

Storage dtypes: the reference stores every parameter in
``cfg.param_dtype`` (f32) and casts the matmul weights and embedding
table to ``cfg.dtype`` at every use (``layers.py:70,76,120``,
``dropless.py:167-169``).  The port keeps those weights in ``cfg.dtype``
once, so the values it multiplies with are identical and the cast is not
repeated each step.  Norm scales/biases, the router and the learned
``pos_embed`` source stay f32, as the reference computes with them.

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


def _dense(cfg: ModelConfig, lead, d_in: int, d_out: int, bias: bool = False):
    out = {"kernel": ParamShape(lead + (d_in, d_out), cfg.dtype, "normal")}
    if bias:
        out["bias"] = ParamShape(lead + (d_out,), "float32", "zeros")
    return out


def _block(cfg: ModelConfig, L: int) -> Dict:
    lead = (L,)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = {
        "wq": _dense(cfg, lead, d, cfg.num_heads * hd, cfg.qkv_bias),
        "wk": _dense(cfg, lead, d, cfg.num_kv_heads * hd, cfg.qkv_bias),
        "wv": _dense(cfg, lead, d, cfg.num_kv_heads * hd, cfg.qkv_bias),
        "wo": _dense(cfg, lead, cfg.num_heads * hd, d),
    }
    if cfg.qk_norm:
        attn["q_norm"] = ParamShape(lead + (hd,), "float32", "ones")
        attn["k_norm"] = ParamShape(lead + (hd,), "float32", "ones")
    gated = cfg.ffn_activation in ("swiglu", "geglu")
    m = cfg.moe
    if m.num_experts > 0:
        if m.routing != "topk":
            raise NotImplementedError(
                f"routing {m.routing!r} is not ported (topk only)")
        E = m.num_experts
        ffn = {"up": ParamShape(lead + (E, d, cfg.d_ff), cfg.dtype, "normal"),
               "down": ParamShape(lead + (E, cfg.d_ff, d), cfg.dtype, "normal"),
               "router": ParamShape(lead + (d, E), "float32", "normal")}
        if gated:
            ffn["gate"] = ParamShape(lead + (E, d, cfg.d_ff), cfg.dtype, "normal")
    else:
        ffn = {"up": _dense(cfg, lead, d, cfg.d_ff),
               "down": _dense(cfg, lead, cfg.d_ff, d)}
        if gated:
            ffn["gate"] = _dense(cfg, lead, d, cfg.d_ff)
    return {"ln_attn": _norm(cfg, lead), "ln_ffn": _norm(cfg, lead),
            "attn": attn, "ffn": ffn}


def lm_shapes(cfg: ModelConfig) -> Dict:
    """Param shape tree, key for key the reference's ``lm_specs`` tree."""
    if cfg.moe.num_experts > 0 and cfg.moe_layer_period != 1:
        raise NotImplementedError(
            "mixed dense/MoE layer stacks are not ported (moe_layer_period=1 only)")
    if cfg.moe.moe_attention:
        raise NotImplementedError("moe_attention is not ported")
    table = ParamShape((padded_vocab(cfg.vocab_size), cfg.d_model), cfg.dtype, "normal")
    tree = {"embed": {"table": table}, "final_norm": _norm(cfg),
            "blocks": _block(cfg, cfg.num_layers)}
    if cfg.pos_embed == "learned":
        tree["pos_embed"] = ParamShape((cfg.max_seq_len, cfg.d_model), "float32", "normal")
    if not cfg.tie_embeddings:
        tree["unembed"] = {"table": table}
    return tree


def _map(fn, tree, path=()):
    if isinstance(tree, ParamShape):
        return fn(path, tree)
    return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}


def count_params(cfg: ModelConfig) -> int:
    total = []
    _map(lambda p, s: total.append(int(np.prod(s.shape))), lm_shapes(cfg))
    return sum(total)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict:
    """Random params from a ``torch.Generator`` on ``device`` (see module doc)."""
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

    return _map(one, lm_shapes(cfg))


def from_jax_params(tree: Mapping, cfg: ModelConfig, device="cuda") -> Dict:
    """The reference's params (``jax.device_get`` -> numpy leaves) as the
    port's tensors, leaf for leaf, each cast to the port's storage dtype."""
    device = torch.device(device)

    def one(path, s: ParamShape):
        node = tree
        for k in path:
            node = node[k]
        a = np.array(node, dtype=np.float32)      # a writable copy
        if tuple(a.shape) != tuple(s.shape):
            raise ValueError(f"{'/'.join(path)}: shape {a.shape}, expected {s.shape}")
        return torch.from_numpy(a).to(device=device, dtype=torch_dtype(s.dtype))

    return _map(one, lm_shapes(cfg))
