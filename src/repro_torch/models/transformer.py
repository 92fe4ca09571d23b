"""Layer-kind helper shared with ``repro.models.transformer``."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def _is_moe_layer(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.moe.num_experts > 0 and (layer_idx % cfg.moe_layer_period == 0)
