"""Stateless hash routing (``repro.core.routers.hashed``; Roller et al.,
2021, "Hash Layers").

No router weight: each token goes to experts by a fixed integer hash, with
the uniform combine weight 1/k.  With the context's ``token_ids`` the hash
is over the token's vocabulary id (every occurrence of a token routes
alike); rows whose id is -1 (m6's image prefix) fall back to the hash of
the absolute position the context carries, or with no positions to the
group-local position ``g*T + t``.  Choice i targets expert
``(hash + i) % E``, so a token's k choices are distinct experts; capacity
and slots are the token-choice routers' (first come within the group).

The reference hashes in uint32.  PyTorch has almost no uint32 arithmetic,
so :func:`_mix32` works on int64 tensors holding values in [0, 2**32) and
keeps every product below 2**63 (:func:`_mul32`); the low 32 bits of a
wrapped product are exact, so the hash is the reference's bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.routers import base, register_router
from repro_torch.core.routers.base import RoutingPlan

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for ``x`` in [0, 2**32), with ``c`` split into
    16-bit halves so that no product leaves int64 (< 2**49)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """The reference's splitmix-style avalanche on uint32 (the "lowbias32"
    integer hash), a bijection of [0, 2**32); ``x`` an int64 tensor or a
    Python int in that range."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _hash_experts(values: torch.Tensor, E: int) -> torch.Tensor:
    """``_mix32(uint32(values)) % E`` as int64; negative values wrap as the
    reference's cast to uint32 wraps them."""
    return _mix32(values.long() & _M32) % E


def hash_plan(G: int, T: int, cfg: MoEConfig, capacity: int, combine_dtype=torch.float32,
              token_ids: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None, device=None) -> RoutingPlan:
    """The hash plan.  ``token_ids``: optional (G, T) ints, -1 where the
    identity is unknown; ``positions``: optional (G, T) absolute positions
    for those rows (else the group-local position)."""
    E = cfg.num_experts
    k = max(1, min(cfg.top_k, E))
    for t in (token_ids, positions):
        if t is not None:
            device = t.device
    if positions is not None:
        pos = positions
    else:
        pos = (torch.arange(G, device=device)[:, None] * T
               + torch.arange(T, device=device)[None, :])
    h = _hash_experts(pos, E)
    if token_ids is not None:
        h = torch.where(token_ids >= 0, _hash_experts(token_ids, E), h)

    count = torch.zeros(G, E, dtype=torch.float32, device=device)
    experts, slots = [], []
    for i in range(k):
        idx = (h + i) % E                                    # distinct experts
        mask = base.one_hot_f32(idx, E)
        p, count = base.slot_positions(mask, count, token_axis=1)
        experts.append(idx.to(torch.int32))
        slots.append(p.to(torch.int32))

    expert_index = torch.stack(experts, dim=-1)              # (G, T, k)
    slot_index = torch.stack(slots, dim=-1)
    valid = slot_index < capacity
    gate = torch.full((G, T, k), 1.0 / k, dtype=torch.float32, device=device)
    if cfg.normalize_gates:
        gate = base.normalize_gates(gate, valid)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    metrics = base.index_load_metrics(expert_index, valid, E, G * T * k)
    return RoutingPlan(expert_index, slot_index, gate, valid, E, capacity,
                       zero, zero, metrics, combine_dtype)


@register_router
class HashRouter(base.Router):
    name = "hash"

    def weight_shape(self, m: MoEConfig, d_model: int):
        return None             # stateless: no router leaf in the param tree

    def plan(self, x32, w, m: MoEConfig, capacity: int,
             combine_dtype=torch.float32, ctx=None) -> RoutingPlan:
        G, T = x32.shape[0], x32.shape[1]
        ids = ctx.token_ids if ctx is not None else None
        pos = ctx.positions if ctx is not None else None
        return hash_plan(G, T, m, capacity, combine_dtype, token_ids=ids, positions=pos,
                         device=x32.device)
