"""Block-level prefix caching: content-addressed, refcounted, copy-on-write
KV sharing (``repro.serving.prefix_cache``), single device.

* :class:`RefcountedBlockAllocator` — a per-block refcount (slot-table
  bindings), an owner (the slot whose reservation the block is charged to,
  or None for purely shared blocks) and an LRU **cached-free list** of
  blocks whose refcount hit 0 but whose contents are still published;
  allocation takes the free list first and evicts cached blocks (oldest
  first, through ``on_evict``) only under pressure.
* :class:`PrefixIndex` — the bijection between **chain hashes**
  ``H(parent, block tokens)`` and physical blocks.  A hash pins the whole
  prefix from position 0, so absolute positions are part of a block's
  identity.
* :class:`PrefixCachingKVCache` — admission matches the prompt against the
  index and binds the matched blocks into the slot's table (prefill resumes
  at the first uncached token, only the unshared footprint is reserved);
  :meth:`~PrefixCachingKVCache.commit` publishes newly full blocks;
  shared blocks are never write targets, and a truncate into a shared or
  published block detaches the slot onto a copy made on the device.

Host state (tables, refcounts, the index) matches the reference's field for
field, through SLO preemption's swap hooks too: a swap-out records the
bound prefix by chain hash and copies only the owned blocks, and a restore
re-binds what is still published and uploads the rest.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.serving.kv_cache import PagedKVCache

ROOT_HASH = b""          # chain parent of the block at positions [0, bs)


def _require(cond, what: str) -> None:
    if not cond:
        raise AssertionError(f"prefix cache: {what}")


def chain_hash(parent: bytes, block_tokens: np.ndarray) -> bytes:
    """Content identity of one full KV block: its tokens plus the identity
    of everything before it (128-bit blake2b over int32 token bytes)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(parent)
    h.update(np.ascontiguousarray(block_tokens, dtype=np.int32).tobytes())
    return h.digest()


class PrefixIndex:
    """Bijection between chain hashes and physical block ids.  ``put`` is
    first-writer-wins: a hash already bound leaves the new block
    unpublished."""

    def __init__(self):
        self._block_of: Dict[bytes, int] = {}
        self._hash_of: Dict[int, bytes] = {}

    def get(self, h: bytes) -> Optional[int]:
        return self._block_of.get(h)

    def published(self, block: int) -> bool:
        return block in self._hash_of

    def put(self, h: bytes, block: int) -> bool:
        """Bind ``hash -> block``; False when the hash is already taken."""
        if h in self._block_of:
            return False
        if block in self._hash_of:
            raise RuntimeError(f"block {block} already published under another hash")
        self._block_of[h] = block
        self._hash_of[block] = h
        return True

    def drop_block(self, block: int) -> None:
        h = self._hash_of.pop(block)
        del self._block_of[h]

    def check_bijection(self) -> None:
        _require(len(self._block_of) == len(self._hash_of)
                 and all(self._hash_of.get(b) == h for h, b in self._block_of.items()),
                 "index is not a hash <-> block bijection")


class RefcountedBlockAllocator:
    """Free-list allocator with per-block refcounts and an LRU cached-free
    list.  Every block is in exactly one state: **free** (contents
    meaningless), **cached** (refcount 0, still published, reusable by a
    match) or **live** (refcount > 0, optionally owned by a slot)."""

    def __init__(self, num_blocks: int, on_evict: Optional[Callable[[int], None]] = None):
        self.num_blocks = num_blocks
        self.on_evict = on_evict
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # oldest first
        self._ref: Dict[int, int] = {}
        self._owner: Dict[int, Optional[int]] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def cached_count(self) -> int:
        return len(self._cached)

    @property
    def live_count(self) -> int:
        return len(self._ref)

    @property
    def owned_count(self) -> int:
        return sum(1 for o in self._owner.values() if o is not None)

    @property
    def live_shared(self) -> int:
        """Live blocks charged to no reservation (purely shared)."""
        return sum(1 for o in self._owner.values() if o is None)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def owner(self, block: int) -> Optional[int]:
        return self._owner.get(block)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free) + len(self._cached)

    def is_cached(self, block: int) -> bool:
        return block in self._cached

    def alloc(self, n: int, owner: int) -> List[int]:
        """``n`` fresh blocks owned by ``owner`` (refcount 1), evicting LRU
        cached blocks when the free list cannot cover the request."""
        if not self.can_alloc(n):
            raise RuntimeError(f"KV pool exhausted: requested {n} blocks, "
                               f"{len(self._free)} free + {len(self._cached)} cached")
        out: List[int] = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b, _ = self._cached.popitem(last=False)   # LRU: oldest
                if self.on_evict is not None:
                    self.on_evict(b)                      # unpublish
            self._ref[b] = 1
            self._owner[b] = owner
            out.append(b)
        return out

    def bind(self, block: int) -> None:
        """One more table binding (a prefix match): a cached block comes
        back to life ownerless; a live one gains a reference."""
        if block in self._cached:
            del self._cached[block]
            self._ref[block] = 1
            self._owner[block] = None
        else:
            self._ref[block] += 1

    def touch(self, block: int) -> None:
        """Refresh a cached block's LRU position (a lookup hit)."""
        if block in self._cached:
            self._cached.move_to_end(block)

    def release(self, block: int, *, owner_release: bool, published: bool) -> None:
        """Drop one binding (and, with ``owner_release``, the reservation
        charge).  At refcount 0 a published block goes to the cached list,
        any other to the free list."""
        if block not in self._ref:
            raise RuntimeError(f"release of unreferenced KV block {block}")
        if owner_release:
            if self._owner[block] is None:
                raise RuntimeError(f"owner release of ownerless block {block}")
            self._owner[block] = None
        self._ref[block] -= 1
        if self._ref[block] == 0:
            del self._ref[block]
            del self._owner[block]
            if published:
                self._cached[block] = None
                self._cached.move_to_end(block)
            else:
                self._free.append(block)

    def check_conservation(self) -> None:
        free, cached, live = set(self._free), set(self._cached), set(self._ref)
        _require(len(self._free) == len(free), "duplicate block on the free list")
        _require(not (free & cached) and not (free & live) and not (cached & live),
                 "a block is in two states")
        _require(len(free) + len(cached) + len(live) == self.num_blocks,
                 "free + cached + live != num_blocks")
        _require(all(r > 0 for r in self._ref.values()), "live block with refcount 0")
        _require(set(self._owner) == live, "owner map does not cover the live blocks")


class PrefixCachingKVCache(PagedKVCache):
    """``PagedKVCache`` with content-addressed block sharing.  Table entries
    ``[0, bound)`` of a slot are **bound** (matched at admission, read-only,
    possibly shared); ``[bound, held)`` are **owned** (the slot's own
    writes, charged to its exclusive reservation
    ``blocks_needed(total_len) - bound``)."""

    def __init__(self, cfg: ModelConfig, serve: ServeConfig, device="cuda"):
        super().__init__(cfg, serve, device=device)
        self.index = PrefixIndex()
        self.allocator = RefcountedBlockAllocator(self.num_blocks, on_evict=self._on_evict)
        self._slot_bound: Dict[int, int] = {}
        self._slot_chain: Dict[int, List[bytes]] = {}
        self.stats = {"lookups": 0, "hit_tokens": 0, "bound_blocks": 0,
                      "published_blocks": 0, "evicted_blocks": 0,
                      "cow_copies": 0, "cow_detaches": 0}

    def _on_evict(self, block: int) -> None:
        self.index.drop_block(block)
        self.stats["evicted_blocks"] += 1

    def _match_prefix(self, prompt: np.ndarray) -> Tuple[List[bytes], List[int]]:
        """Walk the index over the prompt's full blocks.  At most
        ``prompt_len - 1`` tokens come from the cache: one prompt row must
        run to sample the first generated token."""
        bs = self.block_size
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        hashes: List[bytes] = []
        blocks: List[int] = []
        parent = ROOT_HASH
        for k in range((prompt.size - 1) // bs):
            h = chain_hash(parent, prompt[k * bs:(k + 1) * bs])
            b = self.index.get(h)
            if b is None:
                break
            hashes.append(h)
            blocks.append(b)
            parent = h
        return hashes, blocks

    # -- admission ----------------------------------------------------------

    def _admission_room(self, total_len: int, matched: Sequence[int]) -> bool:
        """Exclusive reservations + shared-pinned blocks (current, plus the
        matched ones that would leave the cached list) must fit the pool."""
        a = self.allocator
        need_excl = self.blocks_needed(total_len) - len(matched)
        newly_live = sum(1 for b in matched if a.refcount(b) == 0)
        return (self.reserved_total + a.live_shared + newly_live + need_excl
                <= self.num_blocks)

    def can_allocate_slot(self, total_len: int, prompt=None) -> bool:
        matched = self._match_prefix(prompt)[1] if prompt is not None else []
        return self._admission_room(total_len, matched)

    def allocate_slot(self, slot: int, total_len: int, prompt=None) -> int:
        """Reserve the unshared footprint and bind the cached prefix into
        the slot's table.  Returns the prompt tokens the bound blocks hold
        K/V for (``cached_tokens``)."""
        if slot in self._slot_reserved:
            raise RuntimeError(f"slot {slot} already allocated")
        hashes, blocks = self._match_prefix(prompt) if prompt is not None else ([], [])
        self.stats["lookups"] += 1
        if not self._admission_room(total_len, blocks):
            raise RuntimeError(
                f"KV pool over-reserved: slot {slot} needs "
                f"{self.blocks_needed(total_len) - len(blocks)} exclusive blocks "
                f"beyond the shared prefix")
        for b in blocks:
            self.allocator.touch(b)
            self.allocator.bind(b)
        self._slot_reserved[slot] = self.blocks_needed(total_len) - len(blocks)
        self.reserved_total += self._slot_reserved[slot]
        self._slot_blocks[slot] = list(blocks)
        self._slot_bound[slot] = len(blocks)
        self._slot_chain[slot] = list(hashes)
        self.block_table[slot, :] = self.garbage_block
        if blocks:
            self.block_table[slot, :len(blocks)] = blocks
        cached_tokens = len(blocks) * self.block_size
        self.stats["hit_tokens"] += cached_tokens
        self.stats["bound_blocks"] += len(blocks)
        return cached_tokens

    # -- publication --------------------------------------------------------

    def commit(self, slot: int, tokens: np.ndarray) -> None:
        """Confirm that positions ``[0, len(tokens))`` of ``slot`` hold K/V
        for exactly ``tokens`` and publish its newly full blocks."""
        bs = self.block_size
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        chain = self._slot_chain[slot]
        held = self._slot_blocks[slot]
        nfull = tokens.size // bs
        if nfull > len(held):
            raise RuntimeError(f"slot {slot}: commit of {tokens.size} tokens but only "
                               f"{len(held)} blocks held")
        for k in range(len(chain), nfull):
            parent = chain[k - 1] if k else ROOT_HASH
            h = chain_hash(parent, tokens[k * bs:(k + 1) * bs])
            chain.append(h)
            if self.index.put(h, held[k]):
                self.stats["published_blocks"] += 1

    def committed_blocks(self, slot: int) -> int:
        """Full blocks of ``slot`` whose token contents are confirmed."""
        return len(self._slot_chain[slot])

    # -- growth / copy-on-write ---------------------------------------------

    def ensure_capacity(self, slot: int, length: int) -> None:
        need = self.blocks_needed(length)
        held = self._slot_blocks[slot]
        if need <= len(held):
            return
        bound = self._slot_bound[slot]
        if need - bound > self._slot_reserved[slot]:
            # only after a truncate released bound blocks (never through the
            # engine): regrowing them would take blocks beyond the reservation
            raise RuntimeError(
                f"slot {slot}: growth to {length} needs {need - bound} exclusive "
                f"blocks, reserved only {self._slot_reserved[slot]} (shared prefix "
                f"blocks were released by truncate)")
        new = self.allocator.alloc(need - len(held), owner=slot)
        self.block_table[slot, len(held):need] = new
        held.extend(new)

    def _cow_replace(self, slot: int, k: int) -> None:
        """Detach table entry ``k`` of ``slot`` from a block others still
        need: release the binding, allocate a fresh block and copy the pool
        rows across on the device (both pools, all layers)."""
        held = self._slot_blocks[slot]
        old = held[k]
        self.allocator.release(old, owner_release=k >= self._slot_bound[slot],
                               published=self.index.published(old))
        if self.allocator.refcount(old) > 0:
            self.stats["cow_detaches"] += 1
        if self.k_pool is None:
            # a detached per-shard sub-cache: only speculative rollback into a
            # partial shared block reaches here, and the engine refuses
            # speculation on a mesh, so this is a guard, not a path
            raise NotImplementedError(
                "copy-on-write detach needs device pools; not supported on "
                "a detached per-shard cache")
        new = self.allocator.alloc(1, owner=slot)[0]
        if new != old:      # eviction can hand the same id straight back
            self.k_pool[:, new] = self.k_pool[:, old]
            self.v_pool[:, new] = self.v_pool[:, old]
            self.stats["cow_copies"] += 1
        held[k] = new
        self.block_table[slot, k] = new
        if k < self._slot_bound[slot]:
            self._slot_bound[slot] = k

    def truncate_slot(self, slot: int, new_len: int) -> None:
        """Rewind ``slot`` to ``new_len`` written positions.  Blocks past it
        are released (published ones to the cached list); the block holding
        ``new_len`` is the copy-on-write edge: bound or shared, the slot
        detaches onto a copy; published and sole, it is unpublished."""
        keep = self.blocks_needed(new_len) if new_len > 0 else 0
        held = self._slot_blocks[slot]
        bound = self._slot_bound[slot]
        for k in range(len(held) - 1, keep - 1, -1):
            self.allocator.release(held[k], owner_release=k >= bound,
                                   published=self.index.published(held[k]))
        if keep < len(held):
            self.block_table[slot, keep:] = self.garbage_block
            del held[keep:]
        self._slot_bound[slot] = min(bound, keep)
        del self._slot_chain[slot][new_len // self.block_size:]
        if new_len % self.block_size != 0 and keep == len(held) and held:
            k = keep - 1                      # partial boundary block
            blk = held[k]
            if k < self._slot_bound[slot] or self.allocator.refcount(blk) > 1:
                self._cow_replace(slot, k)    # others read it: never write it
            elif self.index.published(blk):
                self.index.drop_block(blk)    # sole user: content will diverge

    # -- writes -------------------------------------------------------------

    def write_coords(self, slot: int, position: int) -> Tuple[int, int]:
        b, o = divmod(position, self.block_size)
        blk = int(self.block_table[slot, b])
        if b < self._slot_bound.get(slot, 0):
            raise RuntimeError(f"COW violation: write at position {position} of slot "
                               f"{slot} targets bound (shared, read-only) block {blk}")
        if self.allocator.refcount(blk) > 1:
            raise RuntimeError(f"COW violation: write at position {position} of slot "
                               f"{slot} would land in block {blk} with refcount "
                               f"{self.allocator.refcount(blk)}")
        if self.index.published(blk):
            raise RuntimeError(f"write at position {position} of slot {slot} would "
                               f"rewrite published block {blk} behind the index")
        return blk, o

    # -- preemption swap hooks (repro_torch.serving.slo) ---------------------

    def warm_prefix_tokens(self, prompt) -> int:
        """Prompt tokens a fresh admission would serve from the index now
        (no LRU touch: a policy probe, not a hit)."""
        return len(self._match_prefix(prompt)[1]) * self.block_size

    def swap_footprint(self, slot: int) -> int:
        # bound blocks are shared and re-bindable: never copied
        return len(self._slot_blocks[slot]) - self._slot_bound[slot]

    def swap_out(self, slot: int, swap, *, uid: int, total_len: int, context_len: int):
        """Refcount-aware swap-out: copy only the slot's *owned* blocks to
        the host; the bound shared prefix is recorded by chain hash alone
        (restore re-binds whatever block then holds that content).
        ``free_slot`` then drops the bindings: owned published blocks land
        on the cached list, so an undisturbed pool restores them by re-bind
        too, without the host copies."""
        rec = swap.store(self, uid=uid, total_len=total_len, context_len=context_len,
                         blocks=list(self._slot_blocks[slot]),
                         skip=self._slot_bound[slot], hashes=list(self._slot_chain[slot]))
        self.free_slot(slot)
        return rec

    def _match_record(self, rec) -> Tuple[List[bytes], List[int]]:
        """The leading run of the record's chain still published in the
        index (the re-bindable prefix; it stops at the first evicted hash)."""
        hashes: List[bytes] = []
        blocks: List[int] = []
        for h in rec.hashes:
            b = self.index.get(h)
            if b is None:
                break
            hashes.append(h)
            blocks.append(b)
        return hashes, blocks

    def can_restore(self, rec) -> bool:
        return self._admission_room(rec.total_len, self._match_record(rec)[1])

    def restore_slot(self, slot: int, rec, swap) -> int:
        """Rebuild a preempted slot: re-bind the still-published prefix,
        upload the host copies of the rest, republish the restored full
        blocks.  If a *bound* (never copied) block's hash was evicted, all
        past the hole is unusable, so restore stops there and the engine
        recomputes the tail by resume-prefill; the host copies past the hole
        go with the record.  Returns the resume position."""
        if slot in self._slot_reserved:
            raise RuntimeError(f"slot {slot} already allocated")
        hashes, blocks = self._match_record(rec)
        m = len(blocks)
        # tail uploads exist for every k >= rec.skip; a hole before that
        # (m < skip) leaves nothing usable past position m * block_size
        n_tail = rec.num_blocks - m if m >= rec.skip else 0
        if not self._admission_room(rec.total_len, blocks):
            raise RuntimeError(
                f"KV pool over-reserved: restore of request {rec.uid} into slot {slot} "
                f"needs {self.blocks_needed(rec.total_len) - m} exclusive blocks")
        for b in blocks:
            self.allocator.touch(b)
            self.allocator.bind(b)
        self.stats["bound_blocks"] += m
        self._slot_reserved[slot] = self.blocks_needed(rec.total_len) - m
        self.reserved_total += self._slot_reserved[slot]
        self._slot_blocks[slot] = list(blocks)
        self._slot_bound[slot] = m
        self._slot_chain[slot] = list(hashes)
        self.block_table[slot, :] = self.garbage_block
        if blocks:
            self.block_table[slot, :m] = blocks
        if n_tail == 0:
            return min(m * self.block_size, rec.context_len)
        new = self.allocator.alloc(n_tail, owner=slot)
        self.block_table[slot, m:rec.num_blocks] = new
        self._slot_blocks[slot].extend(new)
        swap.load(self, [(rec.host_of[k], new[k - m]) for k in range(m, rec.num_blocks)])
        # the uploaded *full* blocks hold the recorded chain content again:
        # extend the slot's chain and republish (first writer wins)
        for k in range(m, len(rec.hashes)):
            self._slot_chain[slot].append(rec.hashes[k])
            if self.index.put(rec.hashes[k], self._slot_blocks[slot][k]):
                self.stats["published_blocks"] += 1
        return rec.context_len

    # -- eviction -----------------------------------------------------------

    def free_slot(self, slot: int) -> None:
        held = self._slot_blocks.pop(slot)
        bound = self._slot_bound.pop(slot)
        for k, b in enumerate(held):
            self.allocator.release(b, owner_release=k >= bound,
                                   published=self.index.published(b))
        del self._slot_chain[slot]
        self.reserved_total -= self._slot_reserved.pop(slot)
        self.block_table[slot, :] = self.garbage_block

    # -- invariants ---------------------------------------------------------

    def check_conservation(self) -> None:
        """Refcount/owner/index invariants (the reference's list): the
        partition of the pool, refcount = table bindings, owned blocks past
        each slot's bound region and within its reservation, cached blocks
        all published and free ones never, and -- while no COW detach has
        happened -- the no-starvation witness
        ``free + cached >= reserved_total - owned``."""
        a = self.allocator
        a.check_conservation()
        self.index.check_bijection()
        bindings: Dict[int, int] = {}
        for slot, blocks in self._slot_blocks.items():
            bound = self._slot_bound[slot]
            _require(0 <= bound <= len(blocks), f"slot {slot}: bound {bound} out of range")
            _require(len(blocks) - bound <= self._slot_reserved[slot],
                     f"slot {slot} owns more than it reserved")
            _require(list(self.block_table[slot, :len(blocks)]) == blocks
                     and (self.block_table[slot, len(blocks):] == self.garbage_block).all(),
                     f"slot {slot}: table/blocks mismatch")
            _require(len(self._slot_chain[slot]) <= len(blocks),
                     f"slot {slot}: chain longer than its blocks")
            for k, b in enumerate(blocks):
                bindings[b] = bindings.get(b, 0) + 1
                if k >= bound:
                    _require(a.owner(b) == slot, f"slot {slot}: block {b} not owned by it")
        for b, n in bindings.items():
            _require(a.refcount(b) == n and not a.is_cached(b),
                     f"block {b}: refcount {a.refcount(b)} != {n} bindings, or cached")
        _require(sum(1 for b in bindings if a.owner(b) is not None) == a.owned_count
                 and a.live_count == len(bindings), "live/owned accounting broken")
        for b in range(self.num_blocks):
            if a.is_cached(b):
                _require(self.index.published(b), f"cached block {b} unpublished")
        for b in a._free:
            _require(not self.index.published(b), f"free block {b} published")
        _require(self.reserved_total == sum(self._slot_reserved.values())
                 and self.reserved_total <= self.num_blocks, "reservation accounting broken")
        if self.stats["cow_detaches"] == 0:
            _require(a.free_count + a.cached_count >= self.reserved_total - a.owned_count,
                     "no-starvation witness free + cached >= reserved - owned broken")
        for slot in range(self.block_table.shape[0]):
            if slot not in self._slot_blocks:
                _require((self.block_table[slot] == self.garbage_block).all(),
                         f"free slot {slot} has a dangling table row")

    def occupancy(self) -> list:
        a = self.allocator
        return [{"free": a.free_count, "live": a.live_count, "cached": a.cached_count,
                 "reserved": self.reserved_total, "block_bytes": self.block_bytes}]
