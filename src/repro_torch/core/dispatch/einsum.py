"""Paper-faithful Fig. 7 execution (``repro.core.dispatch.einsum``):
one-hot einsum dispatch -> expert FFN -> einsum combine, through the
plan's dense ``(G, T, E, C)`` view."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.dispatch import register_dispatcher
from repro_torch.core.dispatch.base import expert_ffn
from repro_torch.core.routers.base import RoutingPlan


def einsum_dispatch(params, xg: torch.Tensor, plan: RoutingPlan,
                    cfg: ModelConfig) -> torch.Tensor:
    dt = cfg.activation_dtype
    combine = plan.combine                                     # (G,T,E,C)
    G, T, E, C = combine.shape
    dispatch = (combine > 0.0).to(dt)
    # 'dTZFC,dTZM->ZFdCM' in the paper == 'gtec,gtm->egcm' with E = Z*F
    dispatched = torch.einsum("gtec,gtm->egcm", dispatch, xg.to(dt))
    out = expert_ffn(params, dispatched.reshape(E, G * C, cfg.d_model), cfg)
    out = out.reshape(E, G, C, cfg.d_model)
    return torch.einsum("gtec,egcm->gtm", combine.to(dt), out)


@register_dispatcher
class EinsumDispatcher:
    name = "einsum"

    def __call__(self, params, xg, plan: RoutingPlan, cfg: ModelConfig,
                 ctx: Optional[MoEContext] = None) -> torch.Tensor:
        return einsum_dispatch(params, xg, plan, cfg)
