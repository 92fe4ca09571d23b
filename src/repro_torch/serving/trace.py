"""Request traces (``repro.serving.trace``): JSONL loading, synthetic
Poisson generation (mixed lengths, and multi-tenant shared system prompts)
and the shared latency summary.

Trace format (one JSON object per line)::

    {"prompt_len": 24, "gen_len": 48, "arrival_ms": 130.5}

Prompt contents are synthesized deterministically from the request uid
with numpy, so the same trace gives the same tokens as the reference.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.serving.request import Priority, Request


def _prompt_tokens(uid: int, prompt_len: int, vocab_size: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed * 100003 + uid)
    return rng.integers(0, vocab_size, size=prompt_len, dtype=np.int64).astype(np.int32)


def load_trace(path: str, vocab_size: int, seed: int = 0) -> List[Request]:
    reqs = []
    with open(path) as f:
        for uid, line in enumerate(l for l in f if l.strip()):
            d = json.loads(line)
            dl = d.get("deadline_ms")
            reqs.append(Request(
                uid=uid,
                prompt=_prompt_tokens(uid, int(d["prompt_len"]), vocab_size, seed),
                max_new_tokens=int(d["gen_len"]),
                arrival_ms=float(d.get("arrival_ms", 0.0)),
                priority=d.get("priority", Priority.NORMAL),
                deadline_ms=float(dl) if dl is not None else None))
    reqs.sort(key=lambda r: (r.arrival_ms, r.uid))
    return reqs


def synthetic_trace(num_requests: int, vocab_size: int, *, seed: int = 0,
                    qps: float = 50.0, prompt_lens: Tuple[int, int] = (8, 48),
                    gen_lens: Tuple[int, ...] = (4, 8, 16, 64)) -> List[Request]:
    """Poisson arrivals at ``qps``, uniform prompt lengths, long-tailed
    generation lengths — the mixed-length continuous-batching workload."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1000.0 / qps, size=num_requests))
    reqs = []
    for uid in range(num_requests):
        p = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        g = int(rng.choice(gen_lens))
        reqs.append(Request(
            uid=uid, prompt=_prompt_tokens(uid, p, vocab_size, seed),
            max_new_tokens=g, arrival_ms=float(arrivals[uid])))
    return reqs


def synthetic_multitenant(num_requests: int, vocab_size: int, *, seed: int = 0,
                          qps: float = 50.0, num_tenants: int = 4,
                          system_prompt_len: int = 48,
                          suffix_lens: Tuple[int, int] = (2, 12),
                          gen_lens: Tuple[int, ...] = (4, 8, 16)) -> List[Request]:
    """Poisson arrivals where request ``uid`` belongs to tenant
    ``uid % num_tenants`` and opens with that tenant's fixed
    ``system_prompt_len``-token system prompt, then a short suffix: the
    workload prefix caching targets.  System prompts are deterministic in
    ``(seed, tenant)`` and suffixes in ``(seed, uid)``, so the same
    arguments give byte-identical prompts, the reference's."""
    if num_tenants < 1:
        raise ValueError("synthetic_multitenant: num_tenants must be >= 1")
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1000.0 / qps, size=num_requests))
    # tenant system prompts: uid-space disjoint from the per-request suffixes
    systems = [_prompt_tokens(10**9 + t, system_prompt_len, vocab_size, seed)
               for t in range(num_tenants)]
    reqs = []
    for uid in range(num_requests):
        s = int(rng.integers(suffix_lens[0], suffix_lens[1] + 1))
        g = int(rng.choice(gen_lens))
        reqs.append(Request(
            uid=uid,
            prompt=np.concatenate([systems[uid % num_tenants],
                                   _prompt_tokens(uid, s, vocab_size, seed)]),
            max_new_tokens=g, arrival_ms=float(arrivals[uid])))
    return reqs


def static_max_len(requests: List[Request]) -> int:
    """Cache bound for serving ``requests`` with a lockstep engine."""
    return (max(r.prompt_len for r in requests)
            + max(r.max_new_tokens for r in requests) + 1)


def latency_stats(lats: List[float], total_ms: float, generated: int) -> Dict[str, float]:
    lats = sorted(lats)
    return {
        "total_ms": total_ms,
        "generated_tokens": float(generated),
        "generated_tokens_per_s": generated / max(total_ms / 1e3, 1e-9),
        "p50_ms": lats[len(lats) // 2] if lats else 0.0,
        "p95_ms": lats[min(int(len(lats) * 0.95), len(lats) - 1)] if lats else 0.0,
    }


def latency_line(stats: Dict[str, float]) -> str:
    return (f"{stats['generated_tokens']:.0f} tokens in "
            f"{stats['total_ms'] / 1e3:.2f}s "
            f"({stats['generated_tokens_per_s']:.1f} tok/s), "
            f"latency p50 {stats['p50_ms']:.0f}ms p95 {stats['p95_ms']:.0f}ms")
