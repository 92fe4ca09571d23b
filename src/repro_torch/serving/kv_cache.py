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
caching (``repro_torch.serving.prefix_cache``), the int8/fp8 pools
(``repro_torch.quant.kv_cache``) and, on a serving mesh, the data-sharded
:class:`ShardedPagedKVCache`, each on or off.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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
    """Device block pools + host block table for one model.  With
    ``device=None`` the cache is *detached*: host accounting only, no pools
    (the sharded cache's per-shard sub-caches)."""

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
        """The device pools (none when detached); the quantized variants
        override this."""
        self.k_pool = self.v_pool = None
        if device is None:
            return
        shape = (cfg.num_layers, self.num_blocks + 1, cfg.num_kv_heads,
                 self.block_size, cfg.resolved_head_dim)
        self.k_pool = torch.zeros(shape, dtype=cfg.activation_dtype, device=device)
        self.v_pool = torch.zeros(shape, dtype=cfg.activation_dtype, device=device)

    def detach_pools(self) -> None:
        """Drop the device pools, keeping the host accounting (tables,
        allocator, reservations)."""
        self.k_pool = self.v_pool = None
        self.k_scales = self.v_scales = None

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

    def can_allocate_slot_on(self, slot: int, total_len: int, prompt=None) -> bool:
        """Admission gate for a given slot: every slot draws on the one pool
        here; the sharded cache asks the shard that owns ``slot``."""
        return self.can_allocate_slot(total_len, prompt=prompt)

    def pick_slot(self, free_slots: Sequence[int], total_len: int, prompt=None) -> Optional[int]:
        """The index in ``free_slots`` of the slot an admission takes (the
        last, LIFO), or None when the pool has no room for it."""
        if free_slots and self.can_allocate_slot(total_len, prompt=prompt):
            return len(free_slots) - 1
        return None

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

    def held_blocks(self, slot: int) -> int:
        return len(self._slot_blocks.get(slot, ()))

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


def _single_cache_class(serve: ServeConfig):
    quantized = serve.kv_quant != "none"
    if serve.prefix_cache:
        if quantized:
            from repro_torch.quant.kv_cache import QuantizedPrefixCachingKVCache

            return QuantizedPrefixCachingKVCache
        from repro_torch.serving.prefix_cache import PrefixCachingKVCache

        return PrefixCachingKVCache
    if quantized:
        from repro_torch.quant.kv_cache import QuantizedPagedKVCache

        return QuantizedPagedKVCache
    return PagedKVCache


class ShardedPagedKVCache:
    """D per-shard caches behind the single-cache interface
    (``repro.serving.kv_cache.ShardedPagedKVCache``).

    The mesh's data axis partitions slots contiguously (slot ``s`` lives on
    shard ``s // slots_per_shard``), and each shard runs its own allocator
    (the refcounted prefix-caching one under ``serve.prefix_cache``) over a
    private pool slice whose garbage block is its last row.  Block ids in
    tables, write coordinates and the step's rows are **shard-local**.
    Every rank keeps the host accounting of all D shards (identical on every
    rank: the ranks run the same scheduler), as detached sub-caches; the
    device pools are those of this rank's shard ``shard`` alone,
    ``(L, shard_blocks + 1, Hkv, bs, hd)`` (int8 codes plus their
    ``(L, shard_blocks + 1, Hkv)`` f32 scales when quantized).  The
    reference stacks all shards' pools in one array that ``shard_map``
    splits; no rank here ever allocates another shard's rows.

    KV swap-to-host preemption is not supported on a sharded cache (the
    engine refuses ``serve.slo`` with a mesh); its hooks raise, as the
    reference's do.
    """

    def __init__(self, cfg: ModelConfig, serve: ServeConfig, device="cuda", shard: int = 0):
        d = serve.data_shards
        if not 0 <= shard < d:
            raise ValueError(f"shard {shard} of {d} data shards")
        self.cfg = cfg
        self.serve = serve
        self.num_shards = d
        self.shard = shard
        self.block_size = serve.kv_block_size
        self.num_blocks = serve.resolved_num_blocks
        self.slots_per_shard = serve.max_slots // d
        self.shard_blocks = self.num_blocks // d
        self.garbage_block = self.shard_blocks       # shard-local: its slice's last row
        sub_serve = dataclasses.replace(serve, mesh=None, max_slots=self.slots_per_shard,
                                        num_blocks=self.shard_blocks)
        cls = _single_cache_class(serve)
        self.shards = [cls(cfg, sub_serve, device=None) for _ in range(d)]
        # this rank's shard's pools, allocated as that shard's own cache
        # would allocate them
        own = cls(cfg, sub_serve, device=device)
        self.policy = own.policy
        self.k_pool, self.v_pool = own.k_pool, own.v_pool
        self.k_scales, self.v_scales = own.k_scales, own.v_scales

    def _loc(self, slot: int) -> Tuple[int, int]:
        """(shard, shard-local slot) of a global slot id."""
        return divmod(slot, self.slots_per_shard)

    # -- admission / accounting (scheduler-facing) ---------------------------

    @property
    def block_bytes(self) -> int:
        return self.shards[0].block_bytes

    @property
    def max_request_blocks(self) -> int:
        return self.shard_blocks

    @property
    def reserved_total(self) -> int:
        return sum(s.reserved_total for s in self.shards)

    def blocks_needed(self, total_len: int) -> int:
        return -(-total_len // self.block_size)

    def can_allocate_slot(self, total_len: int, prompt=None) -> bool:
        """True when *some* shard has room (the scheduler asks
        :meth:`pick_slot`)."""
        return any(s.can_allocate_slot(total_len, prompt=prompt) for s in self.shards)

    def can_allocate_slot_on(self, slot: int, total_len: int, prompt=None) -> bool:
        d, _ = self._loc(slot)
        return self.shards[d].can_allocate_slot(total_len, prompt=prompt)

    def pick_slot(self, free_slots: Sequence[int], total_len: int, prompt=None) -> Optional[int]:
        """The index in ``free_slots`` of the LIFO-first slot whose shard
        has room (slots are bound to shards), or None."""
        for i in range(len(free_slots) - 1, -1, -1):
            if self.can_allocate_slot_on(free_slots[i], total_len, prompt=prompt):
                return i
        return None

    def allocate_slot(self, slot: int, total_len: int, prompt=None) -> int:
        d, ls = self._loc(slot)
        return self.shards[d].allocate_slot(ls, total_len, prompt=prompt)

    def commit(self, slot: int, tokens) -> None:
        d, ls = self._loc(slot)
        self.shards[d].commit(ls, tokens)

    def committed_blocks(self, slot: int) -> int:
        d, ls = self._loc(slot)
        return self.shards[d].committed_blocks(ls)

    def free_slot(self, slot: int) -> None:
        d, ls = self._loc(slot)
        self.shards[d].free_slot(ls)

    def ensure_capacity(self, slot: int, length: int) -> None:
        d, ls = self._loc(slot)
        self.shards[d].ensure_capacity(ls, length)

    def truncate_slot(self, slot: int, new_len: int) -> None:
        d, ls = self._loc(slot)
        self.shards[d].truncate_slot(ls, new_len)

    def write_coords(self, slot: int, position: int) -> Tuple[int, int]:
        """Shard-local (block, offset): the shard's pool slice is indexed by
        its own block ids."""
        d, ls = self._loc(slot)
        return self.shards[d].write_coords(ls, position)

    def row_table(self, slot: int) -> np.ndarray:
        d, ls = self._loc(slot)
        return self.shards[d].row_table(ls)

    def held_blocks(self, slot: int) -> int:
        d, ls = self._loc(slot)
        return self.shards[d].held_blocks(ls)

    def warm_prefix_tokens(self, prompt) -> int:
        return max(s.warm_prefix_tokens(prompt) for s in self.shards)

    @property
    def stats(self) -> Dict[str, int]:
        """The prefix-cache counters summed over shards."""
        totals: Dict[str, int] = {}
        for s in self.shards:
            for k, v in s.stats.items():
                totals[k] = totals.get(k, 0) + v
        return totals

    def occupancy(self) -> list:
        """One occupancy entry per shard's allocator."""
        return [o for s in self.shards for o in s.occupancy()]

    # -- preemption swap hooks: unsupported under data sharding --------------

    def swap_footprint(self, slot: int) -> int:
        raise NotImplementedError(
            "KV swap-to-host preemption is not supported on a sharded cache")

    def swap_out(self, slot, swap, *, uid, total_len, context_len):
        raise NotImplementedError(
            "KV swap-to-host preemption is not supported on a sharded cache")

    def can_restore(self, rec) -> bool:
        raise NotImplementedError(
            "KV swap-to-host preemption is not supported on a sharded cache")

    def restore_slot(self, slot, rec, swap) -> int:
        raise NotImplementedError(
            "KV swap-to-host preemption is not supported on a sharded cache")

    def check_conservation(self) -> None:
        """Every shard's invariants, then the aggregate: summed reservations
        within the pool, free + live + cached blocks over all shards equal
        to it, and this rank's pools of one shard's rows."""
        for s in self.shards:
            s.check_conservation()
        free = live = cached = 0
        for s in self.shards:
            a = s.allocator
            free += a.free_count
            live += getattr(a, "allocated_count", 0) + getattr(a, "live_count", 0)
            cached += getattr(a, "cached_count", 0)
        if self.reserved_total > self.num_blocks or free + live + cached != self.num_blocks:
            raise AssertionError(
                f"sharded KV cache: reserved {self.reserved_total}, free {free} + live "
                f"{live} + cached {cached} vs {self.num_blocks} blocks")
        if self.k_pool is not None:
            rows = self.shard_blocks + 1
            if self.k_pool.shape[1] != rows or self.v_pool.shape[1] != rows:
                raise AssertionError(f"sharded KV cache: pools of {self.k_pool.shape[1]} rows, "
                                     f"a shard has {rows}")
            if self.k_scales is not None and (
                    tuple(self.k_scales.shape) != tuple(self.k_pool.shape[:3])
                    or self.v_scales.shape != self.k_scales.shape):
                raise AssertionError("sharded KV cache: scale pools do not match code pools")


def make_kv_cache(cfg: ModelConfig, serve: ServeConfig, device="cuda", shard: int = 0):
    """The cache variant ``serve`` asks for: the sharded composition when
    ``serve.mesh`` is set (with this rank's data shard ``shard``'s pools),
    prefix caching when ``serve.prefix_cache``, int8/fp8 pools when
    ``serve.kv_quant != "none"``; all eight combinations compose."""
    if serve.mesh is not None:
        return ShardedPagedKVCache(cfg, serve, device=device, shard=shard)
    return _single_cache_class(serve)(cfg, serve, device=device)
