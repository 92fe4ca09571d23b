"""Block-based paged KV cache (``repro.serving.kv_cache``), single device.

K/V live in a shared pool of fixed-size blocks::

    k_pool, v_pool : (num_layers, P, Hkv, block_size, D)

with ``P = num_blocks + 1``: the last block is the *garbage* block masked
rows write into.  Each decode slot owns an ordered list of pool blocks;
the host-side ``(max_slots, blocks_per_slot)`` block table maps logical
position ``p`` of a slot to ``(table[slot, p // bs], p % bs)``.  Blocks are
*reserved* at admission (the request's worst-case footprint) and
*allocated* on demand as the slot's written length grows, so a running
slot can never find the free list empty.  The pools are device tensors
the engine's step updates in place; the allocator and table are host
Python/numpy, exactly as in the reference.

:func:`make_kv_cache` composes the variants as the reference does: prefix
caching (``repro_torch.serving.prefix_cache``) and the int8/fp8 pools
(``repro_torch.quant.kv_cache``), each on or off.  The sharded cache is not
ported.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` ids with leak and
    double-free detection."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._allocated: set = set()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated_count(self) -> int:
        return len(self._allocated)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: requested {n} blocks, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        self._allocated.update(out)
        return out

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b not in self._allocated:
                raise RuntimeError(f"double-free of KV block {b}")
            self._allocated.remove(b)
            self._free.append(b)

    def check_conservation(self) -> None:
        if len(self._free) + len(self._allocated) != self.num_blocks or (
                set(self._free) & self._allocated):
            raise AssertionError(
                f"KV allocator: {len(self._free)} free + {len(self._allocated)} "
                f"allocated != {self.num_blocks} or overlap")


class PagedKVCache:
    """Device block pools + host block table for one model."""

    # the quantization policy and per-block scale pools: None here; the
    # quantized variants hold int8 codes and (L, P, Hkv) float32 absmax
    # scales indexed by the same block ids
    policy = None
    k_scales = None
    v_scales = None

    def __init__(self, cfg: ModelConfig, serve: ServeConfig, device="cuda"):
        self.cfg = cfg
        self.serve = serve
        self.block_size = serve.kv_block_size
        self.num_blocks = serve.resolved_num_blocks
        self.garbage_block = self.num_blocks          # index P-1, never allocated
        self.allocator = BlockAllocator(self.num_blocks)
        self._alloc_pools(cfg, device)
        self.block_table = np.full((serve.max_slots, serve.blocks_per_slot),
                                   self.garbage_block, dtype=np.int32)
        self._slot_blocks: Dict[int, List[int]] = {}
        self._slot_reserved: Dict[int, int] = {}
        self.reserved_total = 0

    def _alloc_pools(self, cfg: ModelConfig, device) -> None:
        """The device pools; the quantized variants override this."""
        shape = (cfg.num_layers, self.num_blocks + 1, cfg.num_kv_heads,
                 self.block_size, cfg.resolved_head_dim)
        self.k_pool = torch.zeros(shape, dtype=cfg.activation_dtype, device=device)
        self.v_pool = torch.zeros(shape, dtype=cfg.activation_dtype, device=device)

    @property
    def block_bytes(self) -> int:
        """Device bytes one KV block costs across all layers (K + V)."""
        cfg = self.cfg
        per_entry = cfg.num_kv_heads * self.block_size * cfg.resolved_head_dim
        itemsize = torch.empty((), dtype=cfg.activation_dtype).element_size()
        return 2 * cfg.num_layers * per_entry * itemsize

    def blocks_needed(self, total_len: int) -> int:
        return -(-total_len // self.block_size)

    @property
    def max_request_blocks(self) -> int:
        return self.num_blocks

    def can_allocate_slot(self, total_len: int, prompt=None) -> bool:
        """Unreserved room for the worst-case footprint?  ``prompt`` is
        ignored here; the prefix-caching cache charges only the unshared
        part."""
        return self.reserved_total + self.blocks_needed(total_len) <= self.num_blocks

    def row_table(self, slot: int) -> np.ndarray:
        return self.block_table[slot]

    def allocate_slot(self, slot: int, total_len: int, prompt=None) -> int:
        """Reserve ``slot``'s worst-case footprint; returns the prompt
        tokens already backed by cached KV (always 0 here)."""
        if slot in self._slot_reserved:
            raise RuntimeError(f"slot {slot} already allocated")
        need = self.blocks_needed(total_len)
        if self.reserved_total + need > self.num_blocks:
            raise RuntimeError(
                f"KV pool over-reserved: slot {slot} needs {need} blocks, "
                f"{self.num_blocks - self.reserved_total} unreserved")
        self._slot_reserved[slot] = need
        self.reserved_total += need
        self._slot_blocks[slot] = []
        self.block_table[slot, :] = self.garbage_block
        return 0

    def commit(self, slot: int, tokens) -> None:
        """Confirm the tokens behind ``slot``'s written positions: a no-op
        without prefix caching."""

    def free_slot(self, slot: int) -> None:
        blocks = self._slot_blocks.pop(slot)
        if blocks:
            self.allocator.free(blocks)
        self.reserved_total -= self._slot_reserved.pop(slot)
        self.block_table[slot, :] = self.garbage_block

    def ensure_capacity(self, slot: int, length: int) -> None:
        """Allocate missing blocks so positions [0, length) of ``slot`` are backed."""
        need = self.blocks_needed(length)
        held = self._slot_blocks[slot]
        if need > self._slot_reserved[slot]:
            raise RuntimeError(f"slot {slot}: length {length} needs {need} blocks, "
                               f"reserved only {self._slot_reserved[slot]}")
        if need > len(held):
            new = self.allocator.alloc(need - len(held))
            self.block_table[slot, len(held):need] = new
            held.extend(new)

    def truncate_slot(self, slot: int, new_len: int) -> None:
        """Speculative rollback: rewind ``slot`` so only positions
        ``[0, new_len)`` count as written.  Blocks past the new length
        (allocated for rejected draft positions) return to the free list;
        the reservation stays (the request still runs and may grow back).
        No data moves: the next write at a rewound position overwrites the
        stale K/V, which the rows' lengths mask until then."""
        keep = self.blocks_needed(new_len) if new_len > 0 else 0
        held = self._slot_blocks[slot]
        if keep < len(held):
            self.allocator.free(held[keep:])
            self.block_table[slot, keep:] = self.garbage_block
            del held[keep:]

    def write_coords(self, slot: int, position: int) -> Tuple[int, int]:
        b, o = divmod(position, self.block_size)
        return int(self.block_table[slot, b]), o

    # -- preemption swap hooks (repro_torch.serving.slo) ---------------------

    def warm_prefix_tokens(self, prompt) -> int:
        """Prompt tokens already backed by cached KV (the ``cache_aware``
        admission signal): always 0 without prefix caching."""
        return 0

    def swap_footprint(self, slot: int) -> int:
        """Host blocks a swap-out of ``slot`` would take (its owned blocks;
        the prefix cache leaves out the bound shared ones)."""
        return len(self._slot_blocks[slot])

    def swap_out(self, slot: int, swap, *, uid: int, total_len: int, context_len: int):
        """Copy ``slot``'s blocks into the host pool and release the slot
        (blocks, reservation, table row).  Returns the
        :class:`~repro_torch.serving.slo.swap.SwapRecord` restore needs."""
        rec = swap.store(self, uid=uid, total_len=total_len, context_len=context_len,
                         blocks=list(self._slot_blocks[slot]), skip=0, hashes=[])
        self.free_slot(slot)
        return rec

    def can_restore(self, rec) -> bool:
        """Admission gate of a preempted request: the reservation test of a
        fresh request of the recorded worst-case footprint."""
        return self.can_allocate_slot(rec.total_len)

    def restore_slot(self, slot: int, rec, swap) -> int:
        """Rebuild ``slot`` from a swap record: re-reserve the footprint,
        allocate blocks for the recorded context and upload the host
        copies.  Returns the resume position (the whole recorded context
        here; the prefix cache may return less).  The caller releases the
        record's host blocks afterwards."""
        self.allocate_slot(slot, rec.total_len)
        self.ensure_capacity(slot, rec.context_len)
        held = self._slot_blocks[slot]
        swap.load(self, [(rec.host_of[k], held[k]) for k in range(rec.num_blocks)])
        return rec.context_len

    def check_conservation(self) -> None:
        self.allocator.check_conservation()
        held_total = 0
        for slot, blocks in self._slot_blocks.items():
            held_total += len(blocks)
            ok = (len(blocks) <= self._slot_reserved[slot]
                  and list(self.block_table[slot, :len(blocks)]) == blocks
                  and (self.block_table[slot, len(blocks):] == self.garbage_block).all())
            if not ok:
                raise AssertionError(f"KV cache: slot {slot} table/blocks mismatch")
        for slot in range(self.block_table.shape[0]):
            if slot not in self._slot_blocks and not (
                    self.block_table[slot] == self.garbage_block).all():
                raise AssertionError(f"KV cache: free slot {slot} has a dangling table row")
        if (held_total != self.allocator.allocated_count
                or self.reserved_total != sum(self._slot_reserved.values())
                or self.reserved_total > self.num_blocks):
            raise AssertionError("KV cache: held/reserved accounting broken")

    def occupancy(self) -> list:
        a = self.allocator
        return [{"free": a.free_count, "live": a.allocated_count, "cached": 0,
                 "reserved": self.reserved_total, "block_bytes": self.block_bytes}]


def make_kv_cache(cfg: ModelConfig, serve: ServeConfig, device="cuda") -> PagedKVCache:
    """The cache variant ``serve`` asks for: prefix caching when
    ``serve.prefix_cache``, int8/fp8 pools when ``serve.kv_quant != "none"``,
    all four combinations (``repro.serving.kv_cache.make_kv_cache`` without
    the mesh, which is not ported)."""
    if serve.mesh is not None:
        raise NotImplementedError("the sharded (mesh) KV cache is not ported")
    quantized = serve.kv_quant != "none"
    if serve.prefix_cache:
        if quantized:
            from repro_torch.quant.kv_cache import QuantizedPrefixCachingKVCache

            return QuantizedPrefixCachingKVCache(cfg, serve, device=device)
        from repro_torch.serving.prefix_cache import PrefixCachingKVCache

        return PrefixCachingKVCache(cfg, serve, device=device)
    if quantized:
        from repro_torch.quant.kv_cache import QuantizedPagedKVCache

        return QuantizedPagedKVCache(cfg, serve, device=device)
    return PagedKVCache(cfg, serve, device=device)
