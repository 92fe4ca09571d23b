"""The kernel execution backend (``repro.core.dispatch.pallas``, the name
kept so configs carry over): gather dispatch feeding the grouped
expert-FFN kernel (:mod:`repro_torch.kernels.moe_ffn`, hand-written CUDA
on the card).  Its autograd Function makes this backend trainable."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.context import MoEContext
from repro_torch.core.dispatch import register_dispatcher
from repro_torch.core.dispatch.gather import gather_dispatch
from repro_torch.core.routers.base import RoutingPlan


@register_dispatcher
class PallasDispatcher:
    name = "pallas"

    def __call__(self, params, xg, plan: RoutingPlan, cfg: ModelConfig,
                 ctx: Optional[MoEContext] = None) -> torch.Tensor:
        return gather_dispatch(params, xg, plan, cfg, use_kernel=True)
