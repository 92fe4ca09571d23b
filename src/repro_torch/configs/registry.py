"""Architecture registry: --arch <id> -> (full config, smoke config)
(``repro.configs.registry``), every id of the reference."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "m6-base": "repro_torch.configs.m6",
    "m6-10b": "repro_torch.configs.m6",
    "m6-100b": "repro_torch.configs.m6",
    "m6-1t": "repro_torch.configs.m6",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
}

_M6_ATTR = {"m6-base": "M6_BASE", "m6-10b": "M6_10B",
            "m6-100b": "M6_100B", "m6-1t": "M6_1T"}

ALL_IDS = list(_ARCH_MODULES)
ARCH_IDS = [a for a in ALL_IDS if not a.startswith("m6")]


def get_module(arch: str):
    if arch not in ALL_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {ALL_IDS}")
    return importlib.import_module(_ARCH_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    mod = get_module(arch)
    if arch in _M6_ATTR:
        return getattr(mod, _M6_ATTR[arch])
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return get_module(arch).smoke()
