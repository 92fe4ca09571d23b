"""Token -> expert routing through the router registry (``repro.core.routing``).
All routing math runs in float32 regardless of activation dtype."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.routers import get_router
from repro_torch.core.routers.base import RoutingPlan


def route(x: torch.Tensor, router_w: Optional[torch.Tensor], cfg: MoEConfig,
          capacity: int, ctx: Optional[MoEContext] = None) -> RoutingPlan:
    x32 = x.float()
    cd = torch.float32 if cfg.combine_dtype == "float32" else x.dtype
    return get_router(cfg.routing).plan(x32, router_w, cfg, capacity,
                                        combine_dtype=cd, ctx=ctx)
