"""Host-side KV block pool for preemption swap-out and swap-in
(``repro.serving.slo.swap``).

Preempting a running request frees its slot and device KV blocks for a
more urgent one; to resume later without recomputing its context, the
victim's block *contents* move to a preallocated host pool and its
block-table row becomes a :class:`SwapRecord`.  The copy is
**refcount-aware**: blocks the slot only *binds* from the prefix cache
(shared, read-only: table indices ``[0, skip)``) are not copied; the record
keeps their chain hashes, and restore re-binds whichever block the prefix
index then maps each hash to.  Only the slot's *owned* blocks go to the
host.

Restore is the mirror image: re-bind the leading recorded hashes still
published, upload the host copies into fresh device blocks, and hand the
engine a resume position.  If a bound block's hash was evicted meanwhile (a
*hole*), the copies past it are useless (K/V at position p needs every
position before it), so restore stops there and the engine recomputes the
tail by resume-prefill from the request's confirmed tokens.

The host pools are CPU tensors in the device pool's own dtype (bf16, or the
int8 codes of the int8 and fp8 caches), host-block-major ``(host_blocks, L,
Hkv, bs, D)``, and a quantized cache's f32 scale rows ``(host_blocks, L,
Hkv)`` ride along verbatim: swap-out then restore is a byte identity, and
nothing is re-quantized in flight.  Both directions are synchronous: the
device-to-host copy returns once the bytes are in the host pool, and the
upload copies from a tensor gathered out of the pool first, so a store
into a host block released right after a restore cannot overwrite bytes
still in flight.

The reference pads every gather and scatter to a fixed width and runs them
once at construction (``_prewarm``): XLA compiles per index shape, and a
new block count would recompile inside a serving step.  PyTorch indexes
eagerly at any length, and the padded entries only repeat a real block's
bytes, so the port copies exactly the blocks it needs and has no prewarm.

Conservation: a host block is held by exactly one live record, and device
and host accounting never overlap (swap-out frees the device blocks in the
step it fills the host ones).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.serving.kv_cache import BlockAllocator


@dataclasses.dataclass
class SwapRecord:
    """Everything needed to rebuild one preempted slot.  ``hashes`` covers
    the slot's committed *full* blocks (bound prefix, then owned and
    published), in table order; ``host_of`` maps table index ``k`` to the
    host block holding its copy, for every owned block (``k >= skip``).
    The partial last block (if any) has a host copy but no hash."""

    uid: int
    total_len: int                    # worst-case footprint to re-reserve
    context_len: int                  # KV positions written at swap-out
    num_blocks: int                   # device blocks held at swap-out
    skip: int                         # leading bound (shared) blocks, not copied
    hashes: List[bytes]               # chain hash per committed full block
    host_of: Dict[int, int]           # table index -> host block id


class SwapManager:
    """Preallocated host K/V pools (and scale pools, when quantized) plus a
    free-list allocator over them.  Counters: ``swap_outs_total``,
    ``swap_ins_total``, ``swap_swapped_blocks_total`` and
    ``swap_restored_blocks_total`` in the shared registry."""

    def __init__(self, cache, host_blocks: Optional[int] = None, metrics=None):
        self.host_blocks = int(host_blocks) if host_blocks else cache.num_blocks
        layers, _, hkv, bs, hd = cache.k_pool.shape
        shape = (self.host_blocks, layers, hkv, bs, hd)
        self._k_host = torch.zeros(shape, dtype=cache.k_pool.dtype)
        self._v_host = torch.zeros(shape, dtype=cache.v_pool.dtype)
        self._quantized = cache.k_scales is not None
        if self._quantized:
            self._k_scale_host = torch.zeros((self.host_blocks, layers, hkv),
                                             dtype=cache.k_scales.dtype)
            self._v_scale_host = torch.zeros_like(self._k_scale_host)
        self.allocator = BlockAllocator(self.host_blocks)
        self.records: Dict[int, SwapRecord] = {}     # uid -> live record
        if metrics is None:
            from repro_torch.obs import MetricsRegistry

            metrics = MetricsRegistry()
        self.metrics = metrics

    @property
    def stats(self) -> Dict[str, int]:
        """Dict view over the registry counters."""
        m = self.metrics
        return {"swap_outs": int(m.get("swap_outs_total")),
                "swap_ins": int(m.get("swap_ins_total")),
                "swapped_blocks": int(m.get("swap_swapped_blocks_total")),
                "restored_blocks": int(m.get("swap_restored_blocks_total"))}

    def can_store(self, n_blocks: int) -> bool:
        return self.allocator.can_alloc(n_blocks)

    @property
    def used_host_blocks(self) -> int:
        return self.allocator.allocated_count

    def _pairs(self, cache):
        """(device pool, host pool) pairs: K and V, then the scale rows."""
        out = [(cache.k_pool, self._k_host), (cache.v_pool, self._v_host)]
        if self._quantized:
            out += [(cache.k_scales, self._k_scale_host),
                    (cache.v_scales, self._v_scale_host)]
        return out

    def store(self, cache, *, uid: int, total_len: int, context_len: int,
              blocks: Sequence[int], skip: int, hashes: Sequence[bytes]) -> SwapRecord:
        """Copy ``blocks[skip:]`` (the slot's owned blocks) to the host and
        return the record.  The caller still owns the device blocks and
        frees them through the cache right after."""
        if uid in self.records:
            raise RuntimeError(f"request {uid} already has a live swap record")
        copy_ks = list(range(skip, len(blocks)))
        host_ids = self.allocator.alloc(len(copy_ks))
        if copy_ks:
            dev = torch.tensor([blocks[k] for k in copy_ks], dtype=torch.long,
                               device=cache.k_pool.device)
            hid = torch.tensor(host_ids, dtype=torch.long)
            for pool, host in self._pairs(cache):
                # (L, n, ...) -> host-block-major (n, L, ...), on the host
                host[hid] = pool[:, dev].movedim(1, 0).cpu()
        rec = SwapRecord(uid=uid, total_len=total_len, context_len=context_len,
                         num_blocks=len(blocks), skip=skip, hashes=list(hashes),
                         host_of=dict(zip(copy_ks, host_ids)))
        self.records[uid] = rec
        self.metrics.counter("swap_outs_total").inc()
        self.metrics.counter("swap_swapped_blocks_total").inc(len(copy_ks))
        return rec

    def load(self, cache, pairs: Sequence[Tuple[int, int]]) -> None:
        """Upload host blocks into device blocks: ``pairs`` is
        ``[(host_id, device_id), ...]``."""
        if not pairs:
            return
        hid = torch.tensor([h for h, _ in pairs], dtype=torch.long)
        dev = torch.tensor([d for _, d in pairs], dtype=torch.long,
                           device=cache.k_pool.device)
        for pool, host in self._pairs(cache):
            pool[:, dev] = host[hid].to(pool.device).movedim(0, 1)
        self.metrics.counter("swap_ins_total").inc()
        self.metrics.counter("swap_restored_blocks_total").inc(len(pairs))

    def release(self, rec: SwapRecord) -> None:
        """Return the record's host blocks (after restore, or when the
        request is dropped while preempted)."""
        if self.records.get(rec.uid) is not rec:
            raise RuntimeError(f"release of stale swap record for {rec.uid}")
        if rec.host_of:
            self.allocator.free(list(rec.host_of.values()))
        del self.records[rec.uid]

    def check_conservation(self) -> None:
        """Host allocator conservation, and every allocated host block held
        by exactly one live record."""
        self.allocator.check_conservation()
        used: set = set()
        for rec in self.records.values():
            ids = set(rec.host_of.values())
            if (len(ids) != len(rec.host_of) or ids & used
                    or any(k < rec.skip for k in rec.host_of)):
                raise AssertionError(f"swap: record {rec.uid} shares or misplaces host blocks")
            used |= ids
        if len(used) != self.allocator.allocated_count:
            raise AssertionError(f"swap: {len(used)} host blocks in records, "
                                 f"{self.allocator.allocated_count} allocated")
