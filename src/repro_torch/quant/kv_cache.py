"""Quantized paged KV caches (``repro.quant.kv_cache``).

:class:`_QuantPools` swaps a paged cache's device pools for int8 *code*
pools ``(L, P, Hkv, bs, D)`` plus float32 absmax *scale* pools
``(L, P, Hkv)`` indexed by the same block table
(``value = policy.decode(code) * scale``, :mod:`repro_torch.quant.policy`).
Everything host-side is inherited unchanged; only pool allocation,
copy-on-write and byte accounting know about the scales.  Detached
(``device=None``: the sharded cache's per-shard sub-caches) a quantized
cache keeps its policy and no pools.  A preemption swap
(:class:`~repro_torch.serving.slo.swap.SwapManager`) copies a block's codes
and its scale rows verbatim both ways, so a restored block decodes exactly
as it did before the swap: nothing is re-quantized in flight.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.quant.policy import get_kv_quant
from repro_torch.serving.kv_cache import PagedKVCache
from repro_torch.serving.prefix_cache import PrefixCachingKVCache

__all__ = ["QuantizedPagedKVCache", "QuantizedPrefixCachingKVCache"]


class _QuantPools:
    """Pool-representation mixin: int8 codes + f32 scales."""

    def _alloc_pools(self, cfg: ModelConfig, device) -> None:
        self.policy = get_kv_quant(self.serve.kv_quant)
        if not self.policy.quantized:
            raise ValueError("quantized cache built with kv_quant='none'; use make_kv_cache")
        self.k_pool = self.v_pool = self.k_scales = self.v_scales = None
        if device is None:          # detached: host accounting only
            return
        rows = self.num_blocks + 1          # + garbage block
        shape = (cfg.num_layers, rows, cfg.num_kv_heads, self.block_size,
                 cfg.resolved_head_dim)
        self.k_pool = torch.zeros(shape, dtype=self.policy.pool_dtype, device=device)
        self.v_pool = torch.zeros(shape, dtype=self.policy.pool_dtype, device=device)
        self.k_scales = torch.zeros((cfg.num_layers, rows, cfg.num_kv_heads),
                                    dtype=torch.float32, device=device)
        self.v_scales = torch.zeros_like(self.k_scales)

    @property
    def block_bytes(self) -> int:
        """int8 codes (one byte each) plus the f32 scale rows, K + V."""
        cfg = self.cfg
        codes = cfg.num_kv_heads * self.block_size * cfg.resolved_head_dim
        scales = cfg.num_kv_heads * 4
        return 2 * cfg.num_layers * (codes + scales)

    def check_conservation(self) -> None:
        super().check_conservation()
        if self.k_pool is None:
            return
        # every pool row has exactly one scale row under the same
        # (layer, block) key: the block table indexes both with the same ids
        want = tuple(self.k_pool.shape[:3])
        if tuple(self.k_scales.shape) != want or tuple(self.v_scales.shape) != want:
            raise AssertionError(f"KV cache: scale pools {tuple(self.k_scales.shape)}/"
                                 f"{tuple(self.v_scales.shape)} vs code pools {want}")


class QuantizedPagedKVCache(_QuantPools, PagedKVCache):
    """:class:`~repro_torch.serving.kv_cache.PagedKVCache` over int8 pools."""


class QuantizedPrefixCachingKVCache(_QuantPools, PrefixCachingKVCache):
    """:class:`~repro_torch.serving.prefix_cache.PrefixCachingKVCache` over
    int8 pools: a copy-on-write detach copies the block's scale rows with
    its code rows, so the copy decodes identically."""

    def _cow_replace(self, slot: int, k: int) -> None:
        held = self._slot_blocks[slot]
        old = held[k]
        super()._cow_replace(slot, k)
        new = held[k]
        if new != old:
            self.k_scales[:, new] = self.k_scales[:, old]
            self.v_scales[:, new] = self.v_scales[:, old]
