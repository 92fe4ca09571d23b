"""Architecture registry: --arch <id> -> (full config, smoke config).
The port serves the four m6 ids only."""
from __future__ import annotations

from repro_torch.configs import m6
from repro_torch.configs.base import ModelConfig

_M6 = {"m6-base": m6.M6_BASE, "m6-10b": m6.M6_10B,
       "m6-100b": m6.M6_100B, "m6-1t": m6.M6_1T}

ALL_IDS = list(_M6)


def get_config(arch: str) -> ModelConfig:
    try:
        return _M6[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; ported: {ALL_IDS}") from None


def get_smoke_config(arch: str) -> ModelConfig:
    get_config(arch)
    return m6.smoke()
