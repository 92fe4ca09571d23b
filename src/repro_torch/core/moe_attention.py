"""MoE attention (M6-T §3.4; ``repro.core.moe_attention``): the Q/K/V/O
projections as mixtures of experts.

One routing decision per token and layer; each expert owns a full
{Wq, Wk, Wv, Wo} set.  Tokens are dispatched once through the dense
``(G, T, E, C)`` view of the plan, projected by their experts' Q/K/V
weights and combined back, attention proper is computed densely, and the
output projection is dispatched and combined through the same routing.
The expert projections are einsums, as the reference computes them (in
XLA, outside any Pallas kernel).

The reference's behaviour, mirrored (ROADMAP queue 3):

* RoPE is applied whatever ``cfg.pos_embed`` says, so under m6's learned
  positions an MoE-attention layer sees RoPE on top of the learned
  positions ``lm_apply`` adds, where a dense layer sees only the latter;
* ``cfg.qkv_bias`` and ``cfg.qk_norm`` are ignored;
* a token dropped at capacity enters attention with q, k and v all zero.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.moe import group_tokens, mesh_aux, straddles
from repro_torch.core.routing import route
from repro_torch.models.attention import _sdpa, causal_mask
from repro_torch.models.layers import apply_rope, rope


def _moe_project(w: torch.Tensor, dispatched: torch.Tensor, dt) -> torch.Tensor:
    """(E, G, C, M) x (E, M, O) -> (E, G, C, O)."""
    return torch.einsum("egcm,emo->egco", dispatched, w.to(dt))


def moe_attention_apply(params, x: torch.Tensor, cfg: ModelConfig, *, positions,
                        causal: bool = True, ctx: Optional[MoEContext] = None
                        ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) normed activations -> (y (B, S, d), aux losses/metrics)."""
    m = cfg.moe
    dt = cfg.activation_dtype
    B, S, M = x.shape
    hd = cfg.resolved_head_dim
    if straddles(B * S, m):
        raise NotImplementedError(
            "moe_attention on a data-sharded mesh whose groups straddle the data ranks: "
            "the global group count must divide over the data axes")
    xg, G = group_tokens(x, m)
    T = xg.shape[1]
    router_w = params.get("router")
    if router_w is not None:
        router_w = router_w.float()
    # attention experts route projections, not token content: the context
    # is positions-only, so the hash router takes its position hash
    actx = ctx.replace(token_ids=None).grouped(G, T) if ctx is not None else None
    plan = route(xg, router_w, m, m.capacity(T), ctx=actx)
    combine = plan.combine                      # the dense view, built once
    disp = (combine > 0.0).to(dt)
    combine = combine.to(dt)
    dispatched = torch.einsum("gtec,gtm->egcm", disp, xg)

    def back(y_egco, out_dim):
        return torch.einsum("gtec,egco->gto", combine, y_egco).reshape(B, S, out_dim)

    q = back(_moe_project(params["wq"], dispatched, dt), cfg.num_heads * hd)
    k = back(_moe_project(params["wk"], dispatched, dt), cfg.num_kv_heads * hd)
    v = back(_moe_project(params["wv"], dispatched, dt), cfg.num_kv_heads * hd)
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    sin, cos = rope(positions, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    mask = causal_mask(S, S, device=x.device) if causal else None
    attn = _sdpa(q, k, v, cfg, mask, causal_offset=0 if causal else None)
    attn = attn.reshape(B, S, cfg.num_heads * hd)
    # the output projection through the same routing decision
    ag, _ = group_tokens(attn, m)
    disp_a = torch.einsum("gtec,gtm->egcm", disp, ag)
    y = back(_moe_project(params["wo"], disp_a, dt), M)
    aux = mesh_aux(plan, gathered=False)
    aux = {k: aux[k] for k in ("moe_aux_loss", "moe_z_loss", "moe_cv", "moe_dropped_fraction")}
    return y.to(x.dtype), aux
