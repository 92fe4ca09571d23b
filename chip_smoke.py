#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and no result line is printed:

1. device   — a CUDA card is required; prints the card's name and power
              limit (nvidia-smi) and turns TF32 off for matmuls and cuDNN.
2. build    — builds every kernel of the serving path from the sources in
              this checkout with nvcc for sm_90a (one nvcc per source, all
              started together) and prints the build seconds.
3. check    — holds each kernel against its plain PyTorch version at the
              serving path's bf16 shapes and edge cases, atol = rtol = 2e-2
              (the reference's own bf16 kernel tolerance).
4. timing   — per kernel: its time, the plain version's, a PyTorch library
              call's as a yardstick, and the bound (the larger of bytes over
              3.35 TB/s and flops over 989 TFLOP/s bf16).
5. serve    — m6-base at full width (5 layers, random weights from a seeded
              torch.Generator) serves synthetic_trace(16, 21128, seed=0)
              through the continuous engine with dropless MoE; every request
              must finish with its budget, the dropped fraction must be
              exactly 0.0, and each kernel's launch count must equal layers x
              engine steps.  Then one mixed step's forward runs twice, through
              the kernels and through the plain versions, and the logits and
              greedy tokens are compared.
6. report   — a {"kernels": [...]} line, the card line, and as the last line
              {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 2e-2                      # bf16 kernel tolerance (atol = rtol)
FLIP_MARGIN = 2e-2              # router-logit gap a bf16 rounding can close
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name: str, got, want) -> float:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs()
    bad = err > TOL + TOL * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max abs err "
                             f"{float(err.max()):.4g}")
    log(f"  {name}: max abs err {float(err.max()):.3g} (atol=rtol={TOL})")
    return float(err.max())


# ---------------------------------------------------------------------------
# Inputs at the serving path's shapes
# ---------------------------------------------------------------------------

def attention_case(N, Hq, Hkv, D, bs, MB, lengths, seed, dtype=None):
    """Pools with a garbage block (last) and per-row block tables laid out
    like the engine's: each row's blocks distinct, the rest garbage."""
    import torch

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    P = N * MB + 1
    kp = torch.randn((P, Hkv, bs, D), generator=g, device="cuda").to(dtype)
    vp = torch.randn((P, Hkv, bs, D), generator=g, device="cuda").to(dtype)
    q = torch.randn((N, Hq, D), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(N * MB, generator=g, device="cuda").reshape(N, MB).int()
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    used = torch.arange(MB, device="cuda")[None, :] * bs < lengths[:, None]
    tables = torch.where(used, perm, torch.full_like(perm, P - 1)).contiguous()
    return q, kp, vp, tables, lengths


def ffn_case(n_choices, E, M, I, seed, act="gelu", bx=None, weights=None):
    """Expert-sorted rows exactly as the dropless dispatcher builds them
    from a top-1 plan over random router logits."""
    import torch

    from repro_torch.configs.base import MoEConfig
    from repro_torch.core.routers.topk import topk_plan
    from repro_torch.kernels.moe_dropless.ops import pick_block_rows

    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((1, n_choices, E), generator=g, device="cuda")
    plan = topk_plan(logits, MoEConfig(num_experts=E, top_k=1, aux_loss_coef=0.0),
                     n_choices)
    bx = bx or pick_block_rows(n_choices, E)
    rag = plan.ragged(bx)
    x = torch.randn((n_choices, M), generator=g, device="cuda").to(torch.bfloat16)
    tok = torch.clamp(rag.token[0], min=0).long()
    xs = x[tok].contiguous()
    if weights is None:
        def w(*shape):
            return (torch.randn(shape, generator=g, device="cuda") * 0.02).to(torch.bfloat16)

        gated = act in ("swiglu", "geglu")
        weights = (w(E, M, I), w(E, M, I) if gated else None, w(E, I, M))
    be = rag.block_expert[0].contiguous()
    return xs, be, weights, rag, bx


# ---------------------------------------------------------------------------
# Bounds (least time the card could take for the same work)
# ---------------------------------------------------------------------------

def attention_bound(q, kp, tables, lengths):
    N, Hq, D = q.shape
    Hkv = kp.shape[1]
    live = float(lengths.sum())
    nbytes = (2 * q.numel() * q.element_size()              # q read, out written
              + 2 * live * Hkv * D * kp.element_size()      # K and V of live positions
              + tables.numel() * 4 + lengths.numel() * 4)
    flops = 4.0 * Hq * D * live
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3, (
        "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S else "operations")


def ffn_bound(xs, be, weights, rag, bx):
    """Only what this layout's data needs: the live rows of x read and of
    the output written, and the weights of the routed experts.  Blocks
    past ``expert_offsets[E]`` are padding clipped to expert E-1, so they
    add neither rows nor an expert."""
    M = xs.shape[1]
    w_up, w_gate, w_down = weights
    I = w_up.shape[2]
    used = int(rag.expert_offsets[0, -1]) // bx            # routed row blocks
    experts = int(be[:used].unique().numel())               # distinct routed experts
    live = int((rag.token[0] >= 0).sum())                   # real (token, choice) rows
    mats = 3 if w_gate is not None else 2
    nbytes = (2 * live * M * xs.element_size() + used * 4
              + experts * mats * M * I * w_up.element_size())
    flops = 2.0 * live * M * I * mats
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3, (
        "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S else "operations")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_check(torch):
    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref

    log("phase 3: kernels against their plain versions")
    errs = {"paged_decode_attention": 0.0, "ragged_ffn": 0.0}
    rng_lengths = [[40, 0, 17, 256, 1, 100, 16, 63],                       # N = 8
                   [37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52,
                    53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68,
                    69, 70, 71, 72, 0, 0, 0, 0]]                           # N = 40
    for i, lens in enumerate(rng_lengths):
        case = attention_case(len(lens), 16, 16, 64, 16, 16, lens, seed=10 + i)
        out = pda.paged_decode_attention(*case)
        torch.cuda.synchronize()
        errs["paged_decode_attention"] = max(errs["paged_decode_attention"], check_close(
            f"paged_decode_attention N={len(lens)}", out, paged_decode_attention_ref(*case)))
        zero_rows = case[4] == 0
        if not (out[zero_rows] == 0).all():
            raise AssertionError("paged_decode_attention: a length-0 row is not exactly 0")
    # G > 1 (Hq=16 over Hkv=4), lengths ending mid-block, and an f32 run
    for dtype, name in ((torch.bfloat16, "G=4 bf16"), (torch.float32, "G=4 f32")):
        case = attention_case(6, 16, 4, 64, 16, 16, [5, 0, 31, 33, 200, 256],
                              seed=20, dtype=dtype)
        out = pda.paged_decode_attention(*case)
        check_close(f"paged_decode_attention {name}", out,
                    paged_decode_attention_ref(*case))

    weights = None
    for n in (8, 40):                               # decode and mixed steps, bx = 8
        xs, be, weights, rag, bx = ffn_case(n, 32, 1024, 4096, seed=30 + n, weights=weights)
        out = rffn.ragged_ffn(xs, be, *weights, "gelu", block_x=bx)
        torch.cuda.synchronize()
        used = int(rag.expert_offsets[0, -1]) // bx
        log(f"  ragged_ffn n={n}: R={xs.shape[0]} rows, bx={bx}, "
            f"{used} expert blocks + {be.numel() - used} trailing padding blocks")
        errs["ragged_ffn"] = max(errs["ragged_ffn"], check_close(
            f"ragged_ffn n={n}", out, ragged_ffn_ref(xs, be, *weights, "gelu")))
    xs, be, w128, _, bx = ffn_case(300, 8, 512, 1024, seed=50, bx=128)   # bx = 128
    check_close("ragged_ffn bx=128", rffn.ragged_ffn(xs, be, *w128, "gelu", block_x=bx),
                ragged_ffn_ref(xs, be, *w128, "gelu"))
    xs, be, wsw, _, bx = ffn_case(40, 8, 256, 512, seed=60, act="swiglu")
    check_close("ragged_ffn swiglu", rffn.ragged_ffn(xs, be, *wsw, "swiglu", block_x=bx),
                ragged_ffn_ref(xs, be, *wsw, "swiglu"))
    return errs, weights


def time_attention(torch, lens, seed):
    """Kernel, plain and SDPA times for one attention call; 16 rotating
    copies of the pools (> 50 MB L2 at 40 rows) so launches read cold."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref

    copies = [attention_case(len(lens), 16, 16, 64, 16, 16, lens, seed=seed + c)
              for c in range(16)]
    it = iter(range(1 << 30))

    def nxt():
        return copies[next(it) % len(copies)]

    k_ms = cuda_ms(lambda: pda.paged_decode_attention(*nxt()))
    p_ms = cuda_ms(lambda: paged_decode_attention_ref(*nxt()))
    q, kp, vp, tables, lengths = copies[0]
    N, Hq, D = q.shape
    Hkv, bs, MB = kp.shape[1], kp.shape[2], tables.shape[1]
    kk = kp[tables.long()].permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    vv = vp[tables.long()].permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    mask = (torch.arange(MB * bs, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q[:, :, None, :], kk, vv,
                                                             attn_mask=mask))
    bound, by = attention_bound(q, kp, tables, lengths)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)


def time_ffn(torch, n, seed, weights):
    """Kernel, plain and grouped_mm times for one ragged FFN call at the
    dispatcher's layout for ``n`` routed choices over 32 experts."""
    import torch.nn.functional as F

    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref

    xs, be, weights, rag, bx = ffn_case(n, 32, 1024, 4096, seed=seed, weights=weights)
    k_ms = cuda_ms(lambda: rffn.ragged_ffn(xs, be, *weights, "gelu", block_x=bx))
    p_ms = cuda_ms(lambda: ragged_ffn_ref(xs, be, *weights, "gelu"), reps=5)
    lib_ms = None
    offs = rag.expert_offsets[0, 1:].contiguous()
    w_up, _, w_down = weights
    try:
        def grouped():
            h = F.gelu(F.grouped_mm(xs, w_up, offs=offs), approximate="tanh")
            return F.grouped_mm(h, w_down, offs=offs)

        live = int(offs[-1])
        ref = ragged_ffn_ref(xs, be, *weights, "gelu")
        if (grouped()[:live].float() - ref[:live].float()).abs().max() <= TOL * 4:
            lib_ms = cuda_ms(grouped)
        else:
            log("  grouped_mm yardstick disagrees with the plain version: not timed")
    except (RuntimeError, TypeError, ValueError) as exc:
        log(f"  grouped_mm does not take these shapes ({type(exc).__name__}: "
            f"{str(exc).splitlines()[0][:160]}): library_ms null")
    bound, by = ffn_bound(xs, be, weights, rag, bx)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)


def phase_timing(torch, ffn_weights):
    """Both kernels at the decode step's shapes (8 rows: the JSON line) and
    at the mixed step's (8 decode rows + a 32-row prefill chunk)."""
    log("phase 4: timing")
    decode_lens = [21, 56, 112, 9, 74, 33, 98, 47]
    mixed_lens = decode_lens + list(range(17, 49))        # chunk rows of one prompt
    shapes = {"decode (N=8)": (decode_lens, 8), "mixed (N=40)": (mixed_lens, 40)}
    out = {}
    for label, (lens, n) in shapes.items():
        out[label] = {"paged_decode_attention": time_attention(torch, lens, seed=70),
                      "ragged_ffn": time_ffn(torch, n, seed=80, weights=ffn_weights)}
        for name, r in out[label].items():
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"  {label} {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library {lib} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return out["decode (N=8)"], out["mixed (N=40)"]


@contextmanager
def plain_versions():
    """Route the forward through the kernels' plain PyTorch versions."""
    from unittest import mock

    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref

    def plain_ffn(x, be, up, gate, down, activation="swiglu", block_x=128):
        return ragged_ffn_ref(x, be, up, gate, down, activation)

    with mock.patch.object(pda, "paged_decode_attention", paged_decode_attention_ref), \
            mock.patch.object(rffn, "ragged_ffn", plain_ffn):
        yield


def phase_serve(torch):
    from repro_torch.configs.base import ServeConfig
    from repro_torch.configs.m6 import M6_BASE
    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.nn import count_params, init_params
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.trace import latency_line, synthetic_trace

    log("phase 5: m6-base continuous serving, 16 requests")
    cfg = M6_BASE.replace_moe(impl="dropless", capacity_factor=None)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  {count_params(cfg) / 1e9:.3f} B params, random init in "
        f"{time.perf_counter() - t0:.1f} s")
    requests = synthetic_trace(16, cfg.vocab_size, seed=0)
    serve = ServeConfig(max_len=max(256, max(r.total_len for r in requests)))

    # warm-up on a throwaway engine (first cuBLAS/allocator calls)
    warm = ContinuousEngine(cfg, params, serve, device="cuda")
    warm.run([Request(uid=0, prompt=requests[0].prompt, max_new_tokens=3)])

    engine = ContinuousEngine(cfg, params, serve, device="cuda")
    pda.paged_decode_attention.launches = 0
    rffn.ragged_ffn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, stats = engine.run(requests)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {"paged_decode_attention": pda.paged_decode_attention.launches,
                "ragged_ffn": rffn.ragged_ffn.launches}

    steps = engine.steps
    for r in requests:
        if len(out[r.uid]) != r.max_new_tokens:
            raise AssertionError(f"request {r.uid}: {len(out[r.uid])} tokens, "
                                 f"budget {r.max_new_tokens}")
    if stats["moe_dropped_fraction"] != 0.0:
        raise AssertionError(f"moe_dropped_fraction {stats['moe_dropped_fraction']} != 0.0")
    want = cfg.num_layers * steps
    for name, n in launches.items():
        if n != want:
            raise AssertionError(f"{name}: {n} launches, expected layers x steps = {want}")
    log(f"  {latency_line(stats)}")
    log(f"  {steps} steps, mean step {wall_ms / steps:.3f} ms (host clock, run wall "
        f"{wall_ms:.1f} ms); launches {launches} = {cfg.num_layers} layers x {steps} steps; "
        f"dropped fraction {stats['moe_dropped_fraction']}")
    e2e = dict(tokens_per_s=stats["generated_tokens_per_s"], p50_ms=stats["p50_ms"],
               p95_ms=stats["p95_ms"], mean_step_ms=wall_ms / steps, steps=steps)

    e2e.update(profile_steps(torch, cfg, params, serve, requests))
    compare_mixed_step(torch, cfg, params, serve, requests)
    return launches, e2e


def profile_steps(torch, cfg, params, serve, requests, n_steps=24):
    """torch.profiler over engine steps of the trace's first 8 requests,
    all admitted at once: device busy share (kernel time over wall time)
    and the kernels that take the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.request import Request

    eng = ContinuousEngine(cfg, params, serve, device="cuda")
    for r in requests[:8]:
        eng.scheduler.add(Request(uid=r.uid, prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens))
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = 0
        while n < n_steps and eng.scheduler.has_work():
            eng.step()
            n += 1
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device kernels (and copies) only: an aten op's own device time is that
    # of the kernels it launched, which are listed again as their own events.
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return float(e.self_device_time_total)

    busy_us = sum(dev_us(e) for e in kernels)
    if busy_us <= 0.0:
        log("  profiler: no device time recorded; device busy share not measured")
        return {"device_busy_share": None}
    log(f"  profiler over {n} steps: device busy {busy_us / 1e3:.2f} ms of "
        f"{wall_us / 1e3:.2f} ms wall ({busy_us / wall_us:.1%} busy; kernels and copies)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:10]:
        log(f"    {dev_us(e) / 1e3:8.3f} ms  {e.count:6d} x  {e.key[:110]}")
    return {"device_busy_share": busy_us / wall_us, "profiled_steps": n,
            "profiled_wall_ms": wall_us / 1e3, "profiled_device_ms": busy_us / 1e3}


@contextmanager
def recorded_routing(store: list):
    """Record, per MoE layer, each row's top-1 expert and its router-logit
    margin over the runner-up (what a bf16 perturbation must overcome to
    flip the routing)."""
    from unittest import mock

    from repro_torch.core import moe

    real = moe.route

    def route(x, router_w, cfg, capacity, ctx=None):
        plan = real(x, router_w, cfg, capacity, ctx=ctx)
        top2 = (x.float() @ router_w.float()).topk(2, dim=-1).values
        store.append((plan.expert_index[..., 0].reshape(-1).clone(),
                      (top2[..., 0] - top2[..., 1]).reshape(-1).clone()))
        return plan

    with mock.patch.object(moe, "route", route):
        yield


def compare_mixed_step(torch, cfg, params, serve, requests, device="cuda"):
    """One mixed step's forward through the kernels, then (same pools,
    same rows) through the plain versions.  The two differ only in f32
    summation order before each bf16 rounding, but a bf16 difference can
    flip a top-1 routing decision whose router logits are nearly tied,
    and a flipped row (and the later rows of its slot, which attend to
    its K/V) then legitimately differs.  So: every routing flip is
    reported with its margin and must be a near-tie (margin < FLIP_MARGIN
    on the row's first flip); rows untouched by a flip must agree within
    TOL + TOL * |logit|; greedy argmax must agree on them, and any row
    whose argmax differs is reported with its logit margin."""
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.request import Request

    eng = ContinuousEngine(cfg, params, serve, device=device)
    for i, (plen, gen) in enumerate(((40, 8), (45, 8), (20, 8))):
        eng.scheduler.add(Request(uid=i, prompt=requests[i].prompt.repeat(3)[:plen],
                                  max_new_tokens=gen))
    while True:
        eng.step()
        if eng.scheduler.prefilling is not None and any(
                st.status.name == "DECODE" for st in eng.scheduler.running.values()):
            break
    sr = eng.build_rows()
    kp0, vp0 = eng.cache.k_pool.clone(), eng.cache.v_pool.clone()
    route_k, route_p = [], []
    with recorded_routing(route_k):
        lk, _ = eng.forward_rows(sr.buffers)
    eng.cache.k_pool.copy_(kp0)
    eng.cache.v_pool.copy_(vp0)
    with plain_versions(), recorded_routing(route_p):
        lp, _ = eng.forward_rows(sr.buffers)
    if device != "cpu":
        torch.cuda.synchronize()
    if not torch.isfinite(lk).all():
        raise AssertionError("kernel-path logits are not finite")

    b = sr.buffers
    live_rows = [r for r in range(sr.num_rows) if b["lengths"][r] > 0]
    affected = set()
    for layer, ((ek, mk), (ep, _)) in enumerate(zip(route_k, route_p)):
        for r in torch.nonzero(ek != ep).flatten().tolist():
            if b["lengths"][r] == 0:
                continue                        # masked row: output discarded
            margin = float(mk[r])
            first = r not in affected
            log(f"  routing near-tie: layer {layer}, row {r} (slot {b['slots'][r]}, "
                f"position {b['positions'][r]}): expert {int(ek[r])} (kernels) vs "
                f"{int(ep[r])} (plain), router-logit margin {margin:.3g}")
            if first and margin > FLIP_MARGIN:
                raise AssertionError(f"routing flipped at margin {margin} > {FLIP_MARGIN}")
            affected.update(q for q in live_rows if b["slots"][q] == b["slots"][r]
                            and b["positions"][q] >= b["positions"][r])
    clean = [r for r in live_rows if r not in affected]
    V = cfg.vocab_size
    lk_c, lp_c = lk[clean, :V], lp[clean, :V]
    diff = float((lk_c - lp_c).abs().max()) if clean else 0.0
    log(f"  mixed step ({sr.num_rows} rows, {len(live_rows)} live, {len(affected)} "
        f"downstream of a routing near-tie): max abs logit diff on the other "
        f"{len(clean)} rows {diff:.4g} (tolerance {TOL} + {TOL} x |logit|, logit "
        f"scale {float(lp[live_rows, :V].abs().max()):.3g}); on all live rows "
        f"{float((lk[live_rows, :V] - lp[live_rows, :V]).abs().max()):.4g}")
    if ((lk_c - lp_c).abs() > TOL + TOL * lp_c.abs()).any():
        raise AssertionError(f"mixed-step logits differ beyond tolerance: {diff}")
    ak, ap = lk[:, :V].argmax(-1), lp[:, :V].argmax(-1)
    for r in live_rows:
        if ak[r] != ap[r]:
            margin = float(lp[r, ap[r]] - lp[r, ak[r]])
            log(f"  argmax differs: row {r} {int(ak[r])} (kernels) vs {int(ap[r])} "
                f"(plain), plain-logit margin {margin:.4g}"
                f"{' (downstream of a routing near-tie)' if r in affected else ''}")
            if r not in affected:
                raise AssertionError(f"greedy argmax differs on row {r} (margin {margin})")
    log(f"  greedy argmax agrees on {sum(int(ak[r] == ap[r]) for r in live_rows)}"
        f"/{len(live_rows)} live rows")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    log("phase 1: device")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"  torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")

    log("phase 2: build")
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build()
    build_s = time.perf_counter() - t0
    log(f"  built {', '.join(reports)} in {build_s:.1f} s (nvcc, sm_90a)")
    for name, rep in reports.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", rep)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", rep)]
        log(f"  {name}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
            f"spill stores up to {max(spills)} bytes (ptxas -v)")

    errs, ffn_weights = phase_check(torch)
    timing, timing_mixed = phase_timing(torch, ffn_weights)
    del ffn_weights
    torch.cuda.empty_cache()
    launches, e2e = phase_serve(torch)

    sources = {
        "paged_decode_attention": (
            "src/repro_torch/kernels/decode_attention/csrc/paged_decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:143"),
        "ragged_ffn": ("src/repro_torch/kernels/moe_dropless/csrc/ragged_ffn.cu",
                       "src/repro/kernels/moe_dropless/kernel.py:80"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        t = timing[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": errs[name],
                        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"serve": e2e, "build_s": build_s, "mixed_step_kernels": timing_mixed}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
