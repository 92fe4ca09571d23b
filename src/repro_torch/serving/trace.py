"""Request traces (``repro.serving.trace``): JSONL loading and saving,
synthetic Poisson generation (mixed lengths, multi-tenant shared system
prompts, bursty mixed-priority overload), the static engine's trace runner,
the shared latency summary and the per-priority-class SLO summary.

Trace format (one JSON object per line)::

    {"prompt_len": 24, "gen_len": 48, "arrival_ms": 130.5}

plus, for SLO workloads, optional ``"priority"`` ("high" | "normal" | "low",
or the int class value) and ``"deadline_ms"`` fields.

Prompt contents are synthesized deterministically from the request uid
with numpy, so the same trace gives the same tokens as the reference.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

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


def synthetic_priority(num_requests: int, vocab_size: int, *, seed: int = 0,
                       qps: float = 20.0, burst_qps: Optional[float] = None,
                       burst_len: int = 8,
                       prompt_lens: Tuple[int, int] = (8, 32),
                       gen_lens: Tuple[int, ...] = (4, 8, 16, 32),
                       class_weights: Tuple[float, float, float] = (0.25, 0.5, 0.25),
                       gen_lens_by_class: Optional[Dict[Priority, Tuple[int, ...]]] = None,
                       deadline_budgets: Optional[Dict[Priority, Tuple[float, float]]] = None,
                       system_prompt_len: int = 0, num_tenants: int = 2,
                       ) -> List[Request]:
    """Bursty mixed-priority overload: the SLO-scheduling workload.

    Arrivals are Poisson with a rate that alternates every ``burst_len``
    requests between ``burst_qps`` (default ``4 * qps``) and ``qps`` —
    sustained bursts are what collapse tail latency under fcfs, and what
    preemption degrades gracefully.  Each request draws a
    :class:`Priority` from ``class_weights`` (HIGH, NORMAL, LOW order).
    ``gen_lens_by_class`` overrides ``gen_lens`` per class — the
    classic shape is short interactive HIGH requests against long batch
    LOW ones, which is exactly where priority scheduling pays.
    ``deadline_budgets`` maps a class to ``(base_ms, per_token_ms)``; a
    request of that class gets ``deadline_ms = arrival + base +
    per_token * gen_len``.  The default gives HIGH a tight budget,
    NORMAL a loose one, LOW none (best-effort).  With
    ``system_prompt_len > 0`` every prompt opens with one of
    ``num_tenants`` shared tenant prefixes (same uid-space convention as
    :func:`synthetic_multitenant`), which is what gives ``cache_aware``
    admission something to prefer.  Deterministic in ``seed``.
    """
    if deadline_budgets is None:
        deadline_budgets = {Priority.HIGH: (400.0, 40.0),
                            Priority.NORMAL: (2000.0, 120.0)}
    rng = np.random.default_rng(seed)
    burst_qps = burst_qps if burst_qps is not None else 4.0 * qps
    classes = [Priority.HIGH, Priority.NORMAL, Priority.LOW]
    weights = np.asarray(class_weights, np.float64)
    weights = weights / weights.sum()
    systems = [_prompt_tokens(10**9 + t, system_prompt_len, vocab_size, seed)
               for t in range(num_tenants)] if system_prompt_len > 0 else None
    reqs = []
    t = 0.0
    for uid in range(num_requests):
        rate = burst_qps if (uid // burst_len) % 2 == 0 else qps
        t += float(rng.exponential(1000.0 / rate))
        pri = classes[int(rng.choice(3, p=weights))]
        p = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        g = int(rng.choice((gen_lens_by_class or {}).get(pri, gen_lens)))
        prompt = _prompt_tokens(uid, p, vocab_size, seed)
        if systems is not None:
            prompt = np.concatenate([systems[uid % num_tenants], prompt])
        budget = deadline_budgets.get(pri)
        deadline = (t + budget[0] + budget[1] * g) if budget else None
        reqs.append(Request(uid=uid, prompt=prompt, max_new_tokens=g,
                            arrival_ms=t, priority=pri, deadline_ms=deadline))
    return reqs


def save_trace(path: str, requests: List[Request]) -> None:
    with open(path, "w") as f:
        for r in requests:
            d = {"prompt_len": r.prompt_len,
                 "gen_len": r.max_new_tokens,
                 "arrival_ms": r.arrival_ms}
            if r.priority is not Priority.NORMAL:
                d["priority"] = r.priority.name.lower()
            if r.deadline_ms is not None:
                d["deadline_ms"] = r.deadline_ms
            f.write(json.dumps(d) + "\n")


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


def slo_class_stats(states: Sequence) -> Dict[str, float]:
    """Per-priority-class latency percentiles and goodput (deadline-met
    fraction) over finished :class:`RequestState`s, as flat float keys
    (``high_p95_ms``, ``low_n``, ``goodput``, ...).  Empty when the
    workload has a single class and no deadlines — plain traffic keeps
    the plain stats dict."""
    states = list(states)
    by_class: Dict[Priority, list] = {}
    for st in states:
        by_class.setdefault(st.request.priority, []).append(st)
    any_deadline = any(st.request.effective_deadline_ms is not None
                       for st in states)
    if len(by_class) <= 1 and not any_deadline:
        return {}
    out: Dict[str, float] = {}
    for pri, sts in by_class.items():
        tag = pri.name.lower()
        lats = sorted(st.latency_ms() for st in sts
                      if st.latency_ms() is not None)
        out[f"{tag}_n"] = float(len(sts))
        out[f"{tag}_p50_ms"] = lats[len(lats) // 2] if lats else 0.0
        out[f"{tag}_p95_ms"] = (lats[min(int(len(lats) * 0.95), len(lats) - 1)]
                                if lats else 0.0)
        met = [st.met_deadline() for st in sts]
        met = [m for m in met if m is not None]
        if met:
            out[f"{tag}_goodput"] = sum(met) / len(met)
    met_all = [st.met_deadline() for st in states]
    met_all = [m for m in met_all if m is not None]
    if met_all:
        out["goodput"] = sum(met_all) / len(met_all)
    return out


def slo_class_line(stats: Dict[str, float]) -> str:
    """Human-readable per-class summary from :func:`slo_class_stats`
    keys (plus the scheduler's preemption counters when present)."""
    parts = []
    for tag in ("high", "normal", "low"):
        if f"{tag}_n" not in stats:
            continue
        seg = (f"{tag} n={stats[f'{tag}_n']:.0f} "
               f"p50 {stats[f'{tag}_p50_ms']:.0f}ms "
               f"p95 {stats[f'{tag}_p95_ms']:.0f}ms")
        if f"{tag}_goodput" in stats:
            seg += f" goodput {stats[f'{tag}_goodput']:.0%}"
        parts.append(seg)
    if "goodput" in stats:
        parts.append(f"overall goodput {stats['goodput']:.0%}")
    if "preemptions" in stats:
        parts.append(f"preemptions {stats['preemptions']:.0f} "
                     f"(swapped {stats.get('swapped_blocks', 0):.0f} blocks, "
                     f"restored {stats.get('restore_tokens', 0):.0f} tokens)")
    return "slo: " + " | ".join(parts) if parts else ""


def run_trace_static(engine, requests: List[Request], batch: int, *,
                     temperature: float = 0.0, seed: int = 0
                     ) -> Tuple[Dict[int, List[int]], Dict[str, float]]:
    """Serve a trace with the lockstep engine
    (:class:`repro_torch.serving.engine.ServingEngine`): FCFS groups of
    ``batch``, prompts right-padded with token 0 to the group's longest,
    every request generating the group's *longest* ``gen_len`` (lockstep
    batching cannot stop a row early: the waste the continuous engine
    removes).  Only each request's first ``gen_len`` tokens count.  Latency
    clock: wall time since the call, fast-forwarded to a group's last
    arrival when the server is idle."""
    need = static_max_len(requests)
    if engine.max_len < need:
        raise ValueError(f"static engine max_len {engine.max_len} < worst-case group "
                         f"prompt+gen {need}")
    t0 = time.perf_counter()
    clock = 0.0
    out: Dict[int, List[int]] = {}
    lats: List[float] = []
    order = sorted(requests, key=lambda r: (r.arrival_ms, r.uid))
    useful = 0
    for i in range(0, len(order), batch):
        group = order[i:i + batch]
        clock = max(clock, (time.perf_counter() - t0) * 1e3,
                    max(r.arrival_ms for r in group))
        S = max(r.prompt_len for r in group)
        gen = max(r.max_new_tokens for r in group)
        prompts = np.zeros((len(group), S), np.int32)
        for j, r in enumerate(group):
            prompts[j, :r.prompt_len] = r.prompt            # right-padded
        toks, _ = engine.generate(prompts, gen, temperature=temperature, seed=seed)
        clock = max(clock, (time.perf_counter() - t0) * 1e3)
        for j, r in enumerate(group):
            out[r.uid] = toks[j, :r.max_new_tokens].tolist()
            useful += r.max_new_tokens
            lats.append(clock - r.arrival_ms)
    return out, latency_stats(lats, clock, useful)


def latency_line(stats: Dict[str, float]) -> str:
    return (f"{stats['generated_tokens']:.0f} tokens in "
            f"{stats['total_ms'] / 1e3:.2f}s "
            f"({stats['generated_tokens_per_s']:.1f} tok/s), "
            f"latency p50 {stats['p50_ms']:.0f}ms p95 {stats['p95_ms']:.0f}ms")
