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

On a mesh the layer computes what the reference's GSPMD computes from its
partition specs, which put the attention experts on the expert axis (the
training mesh's "model"):

* **experts over an axis of n ranks** (E divisible by n): a rank holds
  experts ``[r E / n, (r + 1) E / n)`` of ``wq`` / ``wk`` / ``wv`` /
  ``wo``.  Every rank of the axis holds the same rows and routes them
  alike; a rank dispatches into its own experts (its slice of the dense
  view along ``e``), projects and combines over them, a partial sum of
  the combine, and one ``all_reduce`` over the axis completes q, k and v
  together, another the output.  The dense view and the dispatched
  input enter through ``collectives.copy_to``, whose backward sums the
  ranks' slice-wise gradients once: the router then sees the whole
  combine's gradient on every rank, and its aux and z losses' gradient
  once.  Attention proper runs on whole heads on every rank (the
  reference's rules leave "heads" unsharded when the experts take the
  axis);
* **experts that do not divide over it**: the rules shard the heads
  instead, and the layer gathers its experts whole (cast to the
  activation dtype first; ``grad="slice"``), as ``dispatch.mesh``'s
  ``gathered_experts`` gathers an FFN's;
* **a data-sharded batch whose global groups straddle the data ranks**
  (``core.moe.straddles``): a rank all-gathers the rows and the
  context's positions over the data axes (``grad="sum"``), routes the
  global groups, keeps its rows of q, k and v, and gathers the attention
  output's rows again for the output projection, as ``core.moe`` does for
  the FFN; the aux losses as ``core.moe.mesh_aux`` reports them.

The layer's collectives count under ``collectives.scope(SCOPE)``.  A
layer's forward runs two all-reduces over the expert axis (and, with the
groups on the rank, one of the expert loads over the data axes; where
they straddle, three all-gathers over them); its backward three over the
expert axis (the ``copy_to`` of the dispatched input, of the dense view
and of the output's input) and, where the groups straddle, two
reduce-scatters over the data axes.  Under remat the forward's run again.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.moe import group_tokens, mesh_aux, straddles
from repro_torch.core.routing import route
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import active_rules, data_parallel, tensor_parallel
from repro_torch.models.attention import _sdpa, causal_mask
from repro_torch.models.layers import apply_rope, rope

SCOPE = "moe_attention"     # the collectives' scope of the layer


def _moe_project(w: torch.Tensor, dispatched: torch.Tensor, dt) -> torch.Tensor:
    """(E, G, C, M) x (E, M, O) -> (E, G, C, O)."""
    return torch.einsum("egcm,emo->egco", dispatched, w.to(dt))


def _whole_experts(params, cfg: ModelConfig, dt):
    """``params`` with every expert leaf whose heads the active rules shard
    (the experts not dividing over the model axis) all-gathered whole over
    that axis, cast to ``dt`` first.  Every rank then computes the same
    layer, so the gather's backward keeps each rank its block's gradient
    (``grad="slice"``)."""
    rules = active_rules()
    if rules is None:
        return params
    hd = cfg.resolved_head_dim
    q, kv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    out = dict(params)
    for name, dim, whole, logical in (("wq", 2, q, "heads"), ("wk", 2, kv, "kv_heads"),
                                      ("wv", 2, kv, "kv_heads"), ("wo", 1, q, "heads")):
        if params[name].shape[dim] != whole:
            group = rules.mesh.group(rules.params[logical])
            out[name] = collectives.all_gather(params[name].to(dt), group, dim=dim,
                                               grad="slice")
    return out


def moe_attention_apply(params, x: torch.Tensor, cfg: ModelConfig, *, positions,
                        causal: bool = True, ctx: Optional[MoEContext] = None
                        ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) normed activations -> (y (B, S, d), aux losses/metrics)."""
    with collectives.scope(SCOPE):
        return _apply(params, x, cfg, positions, causal, ctx)


def _apply(params, x, cfg: ModelConfig, positions, causal, ctx):
    m = cfg.moe
    dt = cfg.activation_dtype
    B, S, M = x.shape
    hd = cfg.resolved_head_dim
    actx = ctx.replace(token_ids=None) if ctx is not None else None
    gathered = straddles(B * S, m)
    rows = x
    if gathered:                            # every data rank's rows, in global order
        dgroup, _, d = data_parallel()
        rows = collectives.all_gather(x, dgroup, dim=0, grad="sum")
        if actx is not None and actx.positions is not None:
            actx = actx.replace(positions=collectives.all_gather(actx.positions, dgroup, dim=0))
    xg, G = group_tokens(rows, m)
    T = xg.shape[1]
    router_w = params.get("router")
    if router_w is not None:
        router_w = router_w.float()
    # attention experts route projections, not token content: the context
    # is positions-only, so the hash router takes its position hash
    plan = route(xg, router_w, m, m.capacity(T),
                 ctx=actx.grouped(G, T) if actx is not None else None)
    combine = plan.combine                      # the dense view, built once
    # (group, n, rank) of the axis the rules shard the experts over (they
    # do only where E divides over it)
    ep = tensor_parallel("expert")
    if ep is not None:                          # this rank's experts of the view
        group, n, r = ep
        E = m.num_experts
        combine = collectives.copy_to(combine, group)[:, :, r * E // n:(r + 1) * E // n]
        xg = collectives.copy_to(xg, group)
    else:
        params = _whole_experts(params, cfg, dt)
    disp = (combine > 0.0).to(dt)
    combine = combine.to(dt)

    def back(y_egco, out_dim):
        """Combined back to this rank's rows (a partial sum over the axis's
        experts where they are split)."""
        y = torch.einsum("gtec,egco->gto", combine, y_egco).reshape(rows.shape[0], S, out_dim)
        return y[d * B:(d + 1) * B] if gathered else y

    dispatched = torch.einsum("gtec,gtm->egcm", disp, xg)
    widths = (cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.num_kv_heads * hd)
    qkv = [back(_moe_project(params[w], dispatched, dt), o) for w, o in zip(("wq", "wk", "wv"),
                                                                             widths)]
    if ep is not None:
        qkv = collectives.all_reduce(torch.cat(qkv, dim=-1), ep[0]).split(widths, dim=-1)
    q, k, v = qkv
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
    if gathered:
        attn = collectives.all_gather(attn, dgroup, dim=0, grad="sum")
    ag, _ = group_tokens(attn, m)
    if ep is not None:
        ag = collectives.copy_to(ag, ep[0])
    y = back(_moe_project(params["wo"], torch.einsum("gtec,gtm->egcm", disp, ag), dt), M)
    if ep is not None:
        y = collectives.all_reduce(y, ep[0])
    aux = mesh_aux(plan, gathered)
    aux = {k: aux[k] for k in ("moe_aux_loss", "moe_z_loss", "moe_cv", "moe_dropped_fraction")}
    return y.to(x.dtype), aux
