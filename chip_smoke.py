#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and no result line is printed:

1. device   — a CUDA card is required; prints the card's name and power
              limit (nvidia-smi) and turns TF32 off for matmuls and cuDNN.
2. build    — builds every kernel (serving and training paths) from the
              sources in this checkout with nvcc for sm_90a (one nvcc per
              source, all started together) and prints the build seconds.
3. check    — holds each kernel against its plain PyTorch version at its
              path's shapes and edge cases, atol = rtol = 2e-2 (the
              reference's own bf16 kernel tolerance).
4. timing   — per kernel: its time, the plain version's, a PyTorch library
              call's as a yardstick, and the bound (the larger of bytes over
              3.35 TB/s and flops over 989 TFLOP/s bf16).
5. serve    — m6-base at full width (5 layers, random weights from a seeded
              torch.Generator) serves synthetic_trace(16, 21128, seed=0)
              through the continuous engine with dropless MoE; every request
              must finish with its budget, the dropped fraction must be
              exactly 0.0, and each serving kernel's launch count must equal
              layers x engine steps.  Then one mixed step's forward runs
              twice, through the kernels and through the plain versions, and
              the logits and greedy tokens are compared.
6. train    — m6-base at full width trains through the train CLI's own
              setup (``repro_torch.launch.train``): 8 steps of top-1 routing
              with capacity 1.25 through the grouped-FFN kernel (``pallas``),
              then 4 steps of 4 top-1 expert prototyping.  Every loss and grad
              norm must be finite, the dropped fraction in [0, 1), and the
              grouped-FFN kernel launched layers x steps x 2 times (forward
              and the remat recompute in the backward), the other kernels
              not at all.  Then a profiled pair of steps (device busy share),
              one step's loss and gradients through the kernels against the
              plain versions (routing near-ties reported), a dropless step
              whose expert weights must get the plain path's gradient, and
              ``lm_apply(use_flash=True)`` against ``use_flash=False`` on the
              train batch (the flash kernel launched once per layer).
7. report   — a {"kernels": [...]} line, the card line, and as the last line
              {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""
from __future__ import annotations

import json
import math
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

def roofline(nbytes: float, flops: float):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the flops over the bf16 tensor-core rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_bound(q, kp, tables, lengths):
    N, Hq, D = q.shape
    Hkv = kp.shape[1]
    live = float(lengths.sum())
    nbytes = (2 * q.numel() * q.element_size()              # q read, out written
              + 2 * live * Hkv * D * kp.element_size()      # K and V of live positions
              + tables.numel() * 4 + lengths.numel() * 4)
    flops = 4.0 * Hq * D * live
    return roofline(nbytes, flops)


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
    return roofline(nbytes, flops)


def moe_ffn_bound(x, w_up, w_gate):
    """Every expert's buffer is computed, so every expert's weights are
    read: x read and y written once, the weights once, 2 flops per
    multiply-add of the two (three if gated) matmuls."""
    E, X, M = x.shape
    I = w_up.shape[2]
    mats = 3 if w_gate is not None else 2
    nbytes = 2 * x.numel() * x.element_size() + mats * w_up.numel() * w_up.element_size()
    flops = 2.0 * E * X * M * I * mats
    return roofline(nbytes, flops)


def flash_bound(q, k, causal):
    """q, k, v read and o written once; QK^T and PV over the (causal: lower
    triangle including the diagonal) score entries."""
    B, S, Hq, D = q.shape
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    pairs = S * (S + 1) / 2 if causal else S * S
    flops = 4.0 * B * Hq * D * pairs
    return roofline(nbytes, flops)


def moe_case(E, X, M, I, seed, act="gelu", dtype=None):
    """(E, X, M) capacity buffers and expert weights at 0.02 init scale."""
    import torch

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=g, device="cuda") * 0.02).to(dtype)

    x = torch.randn((E, X, M), generator=g, device="cuda").to(dtype)
    gated = act in ("swiglu", "geglu")
    return x, w(E, M, I), w(E, M, I) if gated else None, w(E, I, M)


def flash_case(B, S, Hq, Hkv, D, seed, dtype=None):
    import torch

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((B, S, h, D), generator=g, device="cuda").to(dtype)
                 for h in (Hq, Hkv, Hkv))


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
    errs.update(check_training_kernels(torch))
    return errs, weights


def check_training_kernels(torch):
    """The grouped-FFN kernel at the training path's capacity buffers (top-1:
    X = 45, 4 top-1: X = 180) and the reference's edge cases; the flash
    kernel at the m6 training shape and at non-power-of-two S, Hkv = 1,
    non-causal and f32."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_ffn import ops as mf
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref

    errs = {"moe_ffn": 0.0, "flash_attention": 0.0}
    for X in (45, 180):
        case = moe_case(32, X, 1024, 4096, seed=90 + X)
        out = mf.moe_ffn(*case, "gelu")
        torch.cuda.synchronize()
        errs["moe_ffn"] = max(errs["moe_ffn"], check_close(
            f"moe_ffn E=32 X={X}", out, moe_ffn_ref(*case, "gelu")))
        del case, out
    for E, X, M, I, act, dt in ((1, 100, 64, 40, "swiglu", torch.float32),
                                (2, 100, 64, 96, "gelu", torch.bfloat16),
                                (3, 13, 128, 44, "relu", torch.float32)):   # I % 8 != 0
        case = moe_case(E, X, M, I, seed=E + X + I, act=act, dtype=dt)
        check_close(f"moe_ffn E={E} X={X} I={I} {act} {str(dt)[6:]}",
                    mf.moe_ffn(*case, act), moe_ffn_ref(*case, act))
    for B, S, Hq, Hkv, D, causal, dt in ((8, 144, 16, 16, 64, True, torch.bfloat16),
                                         (2, 80, 4, 1, 128, False, torch.float32),
                                         (1, 96, 8, 1, 16, True, torch.float32),
                                         (2, 96, 4, 2, 32, False, torch.bfloat16)):
        q, k, v = flash_case(B, S, Hq, Hkv, D, seed=S + D)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = check_close(f"flash_attention B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
                          f"{'causal' if causal else 'full'} {str(dt)[6:]}",
                          out, attention_ref(q, k, v, causal))
        if S == 144:
            errs["flash_attention"] = err
    return errs


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


def time_moe_ffn(torch, X, seed):
    """Kernel, plain and bf16 torch.bmm times for one grouped FFN call on
    the capacity buffers of one m6-base layer (E = 32, M = 1024,
    I = 4096, gelu): the weights are 537 MB, far above the 50 MB L2, so
    every launch reads them cold."""
    import torch.nn.functional as F

    from repro_torch.kernels.moe_ffn import ops as mf
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref

    x, w_up, _, w_down = moe_case(32, X, 1024, 4096, seed=seed)
    k_ms = cuda_ms(lambda: mf.moe_ffn(x, w_up, None, w_down, "gelu"), reps=10)
    p_ms = cuda_ms(lambda: moe_ffn_ref(x, w_up, None, w_down, "gelu"), reps=5)
    lib_ms = cuda_ms(lambda: torch.bmm(F.gelu(torch.bmm(x, w_up), approximate="tanh"),
                                       w_down), reps=10)
    bound, by = moe_ffn_bound(x, w_up, None)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)


def time_flash(torch, B, S, H, D, seed):
    """Kernel, plain and SDPA times for one causal attention call at the
    m6 training shape."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = flash_case(B, S, H, H, D, seed=seed)
    k_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    p_ms = cuda_ms(lambda: attention_ref(q, k, v, True))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True))
    bound, by = flash_bound(q, k, True)
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by)


def phase_timing_training(torch):
    """The training kernels at the training path's shapes: the grouped FFN
    at X = 45 (top-1, the JSON line) and X = 180 (4 top-1), flash at B = 8,
    S = 144, H = 16, D = 64."""
    out = {"moe_ffn": time_moe_ffn(torch, 45, seed=100),
           "moe_ffn X=180": time_moe_ffn(torch, 180, seed=101),
           "flash_attention": time_flash(torch, 8, 144, 16, 64, seed=102)}
    for name, r in out.items():
        log(f"  train {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return out


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

    import repro_torch.kernels.flash_attention as fa_pkg
    import repro_torch.kernels.moe_ffn as mf_pkg
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref

    def plain_ffn(x, be, up, gate, down, activation="swiglu", block_x=128):
        return ragged_ffn_ref(x, be, up, gate, down, activation)

    with mock.patch.object(pda, "paged_decode_attention", paged_decode_attention_ref), \
            mock.patch.object(rffn, "ragged_ffn", plain_ffn), \
            mock.patch.object(mf_pkg, "moe_ffn", moe_ffn_ref), \
            mock.patch.object(fa_pkg, "flash_attention", attention_ref):
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
    import torch

    def route(x, router_w, cfg, capacity, ctx=None):
        plan = real(x, router_w, cfg, capacity, ctx=ctx)
        with torch.no_grad():
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


TRAIN_ARGS = ["--arch", "m6-base", "--moe-impl", "pallas", "--batch", "8", "--seq", "144",
              "--log-every", "1"]


def train_run(torch, extra, steps):
    """``repro_torch.launch.train.main`` itself for ``steps`` steps, logging
    every step (each log syncs, so each step_time_s is a whole step)."""
    from repro_torch.launch.train import main as train_main

    logs = train_main(TRAIN_ARGS + ["--steps", str(steps)] + extra)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for m in logs:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"step {m['step']}: loss {m['loss']}, grad norm {m['grad_norm']}")
        if not 0.0 <= m["moe_dropped_fraction"] < 1.0:
            raise AssertionError(f"step {m['step']}: dropped fraction {m['moe_dropped_fraction']}")
    return logs


def train_setup(argv):
    """(cfg, state, step_fn, pipeline) exactly as the train CLI builds them."""
    from repro_torch.launch.train import build_parser, setup

    cfg, _, step_fn, state, pipeline = setup(build_parser().parse_args(argv))
    return cfg, state, step_fn, pipeline


def phase_train(torch):
    """m6-base training through the train CLI; returns (launches, e2e)."""
    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_ffn import ops as mf

    log("phase 6: m6-base training, 8 top-1 steps then 4 steps of 4 top-1 prototyping")
    counters = {"moe_ffn": mf.moe_ffn, "flash_attention": fa.flash_attention,
                "ragged_ffn": rffn.ragged_ffn, "paged_decode_attention": pda.paged_decode_attention}
    e2e, launches = {}, {}
    for label, extra, steps in (("top-1", [], 8), ("4 top-1", ["--routing", "prototype", "--k", "4"], 4)):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        logs = train_run(torch, extra, steps)
        got = {name: fn.launches for name, fn in counters.items()}
        want = 5 * steps * 2        # layers x steps x (forward + remat recompute)
        if got["moe_ffn"] != want or any(got[n] for n in got if n != "moe_ffn"):
            raise AssertionError(f"{label}: launches {got}, expected moe_ffn = 5 layers x "
                                 f"{steps} steps x 2 = {want} and no other kernel")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        steady = logs[1:]                           # step 0 carries first-call set-up
        step_ms = sum(m["step_time_s"] for m in steady) / len(steady) * 1e3
        e2e[label] = dict(
            mean_step_ms=step_ms, tokens_per_s=8 * 144 / (step_ms / 1e3),
            first_step_ms=logs[0]["step_time_s"] * 1e3,
            losses=[m["loss"] for m in logs], grad_norms=[m["grad_norm"] for m in logs],
            dropped_fraction=[m["moe_dropped_fraction"] for m in logs],
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"  {label}: {steps} steps, moe_ffn launches {got['moe_ffn']} = 5 layers x {steps} "
            f"steps x 2 (forward + remat recompute); mean step {step_ms:.1f} ms over steps "
            f"1-{steps - 1} (host clock, synced), {e2e[label]['tokens_per_s']:.0f} tokens/s, "
            f"first step {e2e[label]['first_step_ms']:.0f} ms, peak memory "
            f"{e2e[label]['peak_memory_gb']:.1f} GB")
        log(f"    losses {[round(x, 4) for x in e2e[label]['losses']]}, dropped fraction "
            f"{[round(x, 4) for x in e2e[label]['dropped_fraction']]}")

    from repro_torch.launch.train import device_batch

    cfg, state, step_fn, pipeline = train_setup(TRAIN_ARGS + ["--steps", "8"])
    batch = device_batch(pipeline.batch_at(0), "cuda")
    e2e["top-1"].update(profile_train_steps(torch, state, step_fn, batch))
    e2e["kernels_vs_plain"] = compare_train_step(torch, cfg, state.params, batch)
    e2e["flash"] = compare_flash_forward(torch, cfg, state.params, batch, fa)
    del state, step_fn
    torch.cuda.empty_cache()
    e2e["dropless"] = dropless_gradient_step(torch, rffn, TRAIN_ARGS + DROPLESS_ARGS)
    return launches, e2e


def profile_train_steps(torch, state, step_fn, batch, n_steps=2):
    """torch.profiler over ``n_steps`` train steps after one warm step:
    device busy share and the kernels that take the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(float(e.self_device_time_total) for e in kernels)
    if busy_us <= 0.0:
        log("  profiler: no device time recorded; device busy share not measured")
        return {"device_busy_share": None}
    log(f"  profiler over {n_steps} train steps: device busy {busy_us / 1e3:.2f} ms of "
        f"{wall_us / 1e3:.2f} ms wall ({busy_us / wall_us:.1%} busy; kernels and copies)")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms  {e.count:6d} x  {e.key[:110]}")
    return {"device_busy_share": busy_us / wall_us, "profiled_steps": n_steps,
            "profiled_wall_ms": wall_us / 1e3, "profiled_device_ms": busy_us / 1e3}


def _flip_report(routes_k, routes_p, layers, seq_len, label):
    """Routing flips between two forwards over (batch x seq_len) tokens, per
    layer (the forward's route calls only: the remat recompute appends
    more), each reported with its router-logit margin.  A flip must be a
    near-tie (margin < FLIP_MARGIN) unless an earlier layer's flip
    reached the token through causal attention (a flipped token moves the
    later tokens of its sequence).  Returns (flips, affected token ids)."""
    flips, affected = [], set()
    for layer, ((ek, mk), (ep, _)) in enumerate(zip(routes_k[:layers], routes_p[:layers])):
        reached = set(affected)
        for r in torch_nonzero(ek != ep):
            margin = float(mk[r])
            flips.append((layer, r, margin))
            log(f"  routing near-tie ({label}): layer {layer}, token {r}: expert {int(ek[r])} "
                f"(kernels) vs {int(ep[r])} (plain), router-logit margin {margin:.3g}")
            if r not in reached and margin > FLIP_MARGIN:
                raise AssertionError(f"{label}: routing flipped at margin {margin} > {FLIP_MARGIN}")
            affected.update(range(r, (r // seq_len + 1) * seq_len))
    return flips, affected


def torch_nonzero(mask):
    return mask.nonzero().flatten().tolist()


def sync(torch, t) -> bool:
    """Wait for the card if ``t`` lives on it; True there.  (The compare
    phases below also run on the CPU at smoke size, as a rehearsal.)"""
    if t.is_cuda:
        torch.cuda.synchronize()
    return t.is_cuda


def compare_train_step(torch, cfg, params, batch):
    """One step's loss and gradients through the kernels, then through the
    plain versions, from the same params and batch.  The two differ in f32
    summation order before bf16 roundings, which can flip a top-1 routing
    near-tie; each flip is reported with its margin and must be a near-tie.
    Loss within 1e-3 + 10 / tokens per flipped token (a token's CE moves by
    about log V at most when its expert changes); the global gradient norm
    within 2e-2 relative; every leaf's gradient cosine to the plain one
    >= 0.99 (>= 0.9 with flips)."""
    from repro_torch.nn import flat_params
    from repro_torch.train.trainer import make_loss_fn

    loss_fn = make_loss_fn(cfg)
    flat = flat_params(params)

    def loss_and_grads(routes):
        with recorded_routing(routes):
            loss, _ = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(flat.values()))
        return float(loss.detach()), grads

    rk, rp = [], []
    lk, gk = loss_and_grads(rk)
    with plain_versions():
        lp, gp = loss_and_grads(rp)
    sync(torch, batch["tokens"])
    seq = batch["tokens"].shape[1] + batch["patch_embeds"].shape[1]
    flips, _ = _flip_report(rk, rp, cfg.num_layers, seq, "train step")
    tokens = batch["labels"].numel()
    loss_tol = 1e-3 + 10.0 * len({r for _, r, _ in flips}) / tokens
    nk = math.sqrt(sum(float(g.float().square().sum()) for g in gk))
    np_ = math.sqrt(sum(float(g.float().square().sum()) for g in gp))
    cos = {name: float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0))
        for name, a, b in zip(flat, gk, gp) if float(b.float().abs().max()) > 0}
    worst = min(cos, key=cos.get)
    log(f"  train step kernels vs plain: loss {lk:.6f} vs {lp:.6f} (|diff| {abs(lk - lp):.3g}, "
        f"tolerance {loss_tol:.3g}); grad norm {nk:.5f} vs {np_:.5f}; lowest leaf gradient "
        f"cosine {cos[worst]:.6f} ({worst}); {len(flips)} routing flips")
    if not all(math.isfinite(v) for v in (lk, lp, nk, np_)):
        raise AssertionError("train step: non-finite loss or gradient norm")
    if abs(lk - lp) > loss_tol:
        raise AssertionError(f"train step loss differs: {lk} vs {lp}")
    if abs(nk - np_) > 2e-2 * np_:
        raise AssertionError(f"train step grad norm differs: {nk} vs {np_}")
    if cos[worst] < (0.9 if flips else 0.99):
        raise AssertionError(f"train step gradient of {worst}: cosine {cos[worst]}")
    return dict(loss=lk, plain_loss=lp, grad_norm=nk, plain_grad_norm=np_,
                min_grad_cosine=cos[worst], routing_flips=len(flips))


def compare_flash_forward(torch, cfg, params, batch, fa):
    """``lm_apply(use_flash=True)`` against ``use_flash=False`` on the train
    batch: logits within 2e-2 + 2e-2 |logit| on tokens untouched by a
    routing near-tie; the flash kernel launched once per layer."""
    from repro_torch.models.transformer import lm_apply

    def run(use_flash, routes):
        with torch.no_grad(), recorded_routing(routes):
            return lm_apply(params, batch["tokens"], cfg, use_flash=use_flash,
                            extra_embeds=batch["patch_embeds"])[0]

    rf, rr = [], []
    fa.flash_attention.launches = 0
    lf = run(True, rf)
    n = fa.flash_attention.launches
    lr = run(False, rr)
    if sync(torch, lf) and n != cfg.num_layers:
        raise AssertionError(f"flash_attention: {n} launches in one forward, expected "
                             f"{cfg.num_layers} (one per layer)")
    B, S = lf.shape[:2]
    flips, affected = _flip_report(rf, rr, cfg.num_layers, S, "flash forward")
    hit = torch.zeros(B * S, dtype=torch.bool, device=lf.device)
    hit[sorted(affected)] = True
    V = cfg.vocab_size
    a, b = lf.reshape(B * S, -1)[~hit, :V].float(), lr.reshape(B * S, -1)[~hit, :V].float()
    diff = float((a - b).abs().max())
    log(f"  lm_apply use_flash=True vs False: {n} flash launches (one per layer); max abs "
        f"logit diff {diff:.4g} on {int((~hit).sum())} of {B * S} tokens (tolerance "
        f"{TOL} + {TOL} x |logit|, logit scale {float(b.abs().max()):.3g}); "
        f"{len(flips)} routing flips")
    if ((a - b).abs() > TOL + TOL * b.abs()).any():
        raise AssertionError(f"flash forward logits differ beyond tolerance: {diff}")
    return dict(max_abs_logit_diff=diff, launches=n, routing_flips=len(flips))


DROPLESS_ARGS = ["--steps", "1", "--batch", "2", "--moe-impl", "dropless",
                 "--capacity-factor", "none"]


def dropless_gradient_step(torch, rffn, argv):
    """One dropless (--moe-impl dropless --capacity-factor none) loss and
    gradient through the ragged-FFN kernel and through its plain version:
    the expert weights' gradients must be nonzero and agree (cosine >=
    0.99, norm within 2e-2)."""
    from repro_torch.launch.train import device_batch
    from repro_torch.nn import flat_params
    from repro_torch.train.trainer import make_loss_fn

    cfg, state, _, pipeline = train_setup(argv)
    device = state.params["embed"]["table"].device
    batch = device_batch(pipeline.batch_at(0), device)
    loss_fn = make_loss_fn(cfg)
    flat = flat_params(state.params)
    names = ["blocks/ffn/up", "blocks/ffn/down", "blocks/ffn/router"]

    def grads():
        loss, _ = loss_fn(state.params, batch)
        return torch.autograd.grad(loss, [flat[n] for n in names])

    rffn.ragged_ffn.launches = 0
    gk = grads()
    n = rffn.ragged_ffn.launches
    with plain_versions():
        gp = grads()
    on_card = sync(torch, gp[0])
    out = {"ragged_ffn_launches": n}
    for name, a, b in zip(names, gk, gp):
        na, nb = float(a.float().norm()), float(b.float().norm())
        cos = float(torch.nn.functional.cosine_similarity(a.float().flatten(),
                                                          b.float().flatten(), dim=0))
        out[name] = dict(norm=na, plain_norm=nb, cosine=cos)
        log(f"  dropless step {name} gradient: norm {na:.5g} (kernel) vs {nb:.5g} (plain), "
            f"cosine {cos:.6f}")
        if na == 0.0 or abs(na - nb) > 2e-2 * nb or cos < 0.99:
            raise AssertionError(f"dropless step: {name} gradient {na} vs {nb}, cosine {cos}")
    if on_card and n != 2 * cfg.num_layers:
        raise AssertionError(f"dropless step: ragged_ffn launched {n} times, expected "
                             f"2 x {cfg.num_layers} (forward + remat recompute)")
    log(f"  dropless step: ragged_ffn launched {n} times (forward + remat recompute)")
    return out


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
    timing.update(phase_timing_training(torch))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, e2e = phase_serve(torch)
    serve_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_launches, train = phase_train(torch)
    train_s = time.perf_counter() - t0
    log(f"  serve phase {serve_s:.1f} s, train phase {train_s:.1f} s")

    sources = {
        "paged_decode_attention": (
            "src/repro_torch/kernels/decode_attention/csrc/paged_decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:143", launches),
        "ragged_ffn": ("src/repro_torch/kernels/moe_dropless/csrc/ragged_ffn.cu",
                       "src/repro/kernels/moe_dropless/kernel.py:80", launches),
        "moe_ffn": ("src/repro_torch/kernels/moe_ffn/csrc/moe_ffn.cu",
                    "src/repro/kernels/moe_ffn/kernel.py:72", train_launches),
        "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:66",
                            {"flash_attention": train["flash"]["launches"]}),
    }
    kernels = []
    for name, (src, replaces, counts) in sources.items():
        t = timing[name]
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[name], "max_abs_err": errs[name],
                        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"serve": e2e, "train": train, "build_s": build_s, "serve_s": serve_s,
                      "train_s": train_s, "mixed_step_kernels": timing_mixed,
                      "moe_ffn_x180": timing["moe_ffn X=180"]}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
