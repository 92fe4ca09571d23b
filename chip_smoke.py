#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and no result line is printed:

1. device   — a CUDA card is required; prints the card's name and power
              limit (nvidia-smi) and turns TF32 off for matmuls and cuDNN.
2. build    — builds every kernel (serving and training paths) from the
              sources in this checkout with nvcc for sm_90a (one nvcc per
              source, all started together) and prints the build seconds,
              registers and spills; the three decode kernels
              (decode_sm90.cuh's decode_kernel in each library) and the
              tensor-core kernels (the grouped FFN's, flash attention's) must
              not spill, the latter must hold HGMMA
              instructions in their SASS (cuobjdump; logged as not checked
              where the toolkit lacks it).
3. check    — holds each kernel against its plain PyTorch version at its
              path's shapes and edge cases, atol = rtol = 2e-2 (the
              reference's own bf16 kernel tolerance); length-0 rows of the
              decode kernels must be exactly 0, and the int8/fp8 codes and
              scales that quant_write_kv writes on the card must equal those
              it writes on the CPU from the same inputs.  The grouped FFN
              (moe_ffn, ragged_ffn) and flash attention must take the route
              their shape and type select (tc_launches): the m6 shapes the
              tensor cores, where each is also held within one bf16 ulp of
              the plain version of that route's numerics (split-h: h as bf16
              hi + lo; split-P: P as bf16 hi + lo); ragged_ffn at the decode
              and mixed steps' rows and at phase 9's model drafter's forward
              (2 routing groups of 1024 rows in one launch).  The paged kernels also
              at every cluster split (1, 2, 4, 8) forced, with a ring of
              stages that wraps (a 1000-token row), f32 at G = 2, 4, 8 and
              D = 32, 128, and a garbage block of 1e4 past every length;
              the dense kernel likewise (every split forced, a wrapping
              ring, f32 at G = 2-8 and D = 32, 128, bf16 at D = 16, and
              cache rows of 1e4 past every length).
4. timing   — per kernel: its time by CUDA events over back-to-back calls
              (for a kernel of a few microseconds, the host's launch rate)
              and its device time (torch.profiler: every kernel one call
              launches), the plain version's time, a PyTorch library call's
              as a yardstick (events and device time), and the bound (the
              larger of bytes over 3.35 TB/s and flops over 989 TFLOP/s
              bf16); for the grouped FFN and flash also their CUDA-core
              route's time, for the FFN each pass's device time; flash at
              both m6 training lengths, S = 144 and 256; the paged kernels
              (bf16 and int8) and the dense kernel at 8 rows x 256
              positions and at the decode step for their chosen split and
              each split forced, with the splits and stages beside each
              time and SDPA's device time beside the dense kernel's; then
              the FFN, flash and dense kernels measured again on the same
              inputs.
5. serve    — m6-base at full width (5 layers, random weights from a seeded
              torch.Generator) serves synthetic_trace(16, 21128, seed=0)
              through the continuous engine with dropless MoE; every request
              must finish with its budget, the dropped fraction must be
              exactly 0.0, and each serving kernel's launch count must equal
              layers x engine steps.  Then one mixed step's forward runs
              twice, through the kernels and through the plain versions, and
              the logits and greedy tokens are compared.
6. train    — first, AdamW's update of m6-shaped leaves at steps 1-4 and the
              trainer's 3-way microbatch average must be bit-equal on the
              card to the CPU's (true divisions; the share a Python-number
              divisor would move is reported).  Then m6-base at full width
              trains through the train CLI's own
              setup (``repro_torch.launch.train``): 8 steps of top-1 routing
              with capacity 1.25 through the grouped-FFN kernel (``pallas``),
              then 4 steps of 4 top-1 expert prototyping.  Every loss and grad
              norm must be finite, the dropped fraction in [0, 1), and the
              grouped-FFN kernel launched layers x steps x 2 times (forward
              and the remat recompute in the backward), all on the tensor
              cores, the other kernels not at all; then the same runs with
              the grouped FFN on its CUDA-core route, for their step times.
              Then a profiled pair of steps (device busy share),
              one step's loss and gradients through the kernels against the
              plain versions (routing near-ties reported), a dropless step
              whose expert weights must get the plain path's gradient, and
              ``lm_apply(use_flash=True)`` against ``use_flash=False`` on the
              train batch (the flash kernel launched once per layer, every
              launch on its tensor-core route).
7. kv      — m6-base served over the quantized and prefix-cached paged KV
              cache, same weights and ServeConfig defaults as phase 5:
              (a) the 16-request trace under kv_quant int8 and fp8 (every
              request finishes its budget, the quantized attention kernel
              launched layers x steps times and the bf16 one never, dropped
              fraction 0.0, conservation holds; token match against phase 5,
              logit divergence of one replayed request through logit_tap, one
              mixed step kernels-vs-plain); (b) equal-byte capacity, bf16
              pools of 8 blocks against int8 pools of 15 (block bytes 327,680
              and 164,480, peak running int8 / bf16 >= 1.3); (c) prefix
              caching on a multi-tenant trace, off and on, under none and
              int8 (cached-token ratio > 0 when on); (d) the dense-cache
              decode kernel on the engine's pools against the paged kernel.
8. ckpt     — checkpoints and restarts at m6-base's widths cut to 2 layers
              (567.4 M parameters, 6.81 GB a training checkpoint) through
              the train CLI's loop, in a temporary directory under build/
              removed at the end (the free space is checked first): two
              straight 4-step runs; a run with --ckpt-every 2 and a failure
              injected before step 3, which run_with_restarts resumes from
              step 2 (the step-2 checkpoint must restore bit-equal to the
              state it was taken from, and the final params differ from a
              straight run's by no more than the two straight runs
              differ); the 16-request trace served from
              restore_params_latest must give the greedy tokens of an engine
              built from the trained params; the serving tree's bf16
              checkpoint must round-trip bit-equal; save seconds, GB/s and
              save_async's snapshot seconds are printed.
9. spec     — m6-base speculative and sampled serving, phase 5's weights
              and trace, gamma 4: (a) greedy speculative decoding over bf16
              pools with the ngram drafter, the model drafter (the target's
              own weights) and a seeded random drafter registered here
              (rejection and rollback at nearly every verify step); each
              run must finish every budget, drop nothing, keep the cache's
              conservation after every step, launch the paged kernel layers
              x steps times and every ragged FFN on the tensor cores, run
              verify steps (the model drafter one that accepts 2 or more
              drafts), and give phase 5's tokens, a request differing first
              only where a non-speculative run's top two logits are a
              near-tie (logit_tap; reported with the gap); (b) ngram over
              int8 pools, held to phase 7a's int8 tokens the same way;
              (c) the sampler: its uniforms on the card equal to the CPU's,
              its tokens over 4096 keys equal but at near-ties, a 20 000-key
              frequency test within 0.015 of softmax(logits / T), and the
              trace with every request at t = 0, greedy (the step-time
              baseline), at T = 0.8 without speculation, with ngram and
              with the model drafter, and at T = 0.05 with the model
              drafter (drafts must be accepted, some verify step must emit
              2 or more tokens), each run twice with one seed and identical;
              (d) every run's tokens/s, mean step, p50/p95, verify steps,
              acceptance and tokens a verify step beside phase 5's, and the
              paged, int8 and ragged FFN kernels' times at the verify
              step's shape (the FFN also at the model drafter's, which
              phase 3 holds against its plain versions).  A profiler
              session counts only when it recorded every launch and a time
              no shorter than the bound (phase 4 and 9 alike).
10. report  — a {"kernels": [...]} line, the card line, and as the last line
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
# the tensor-core grouped FFN against its split-h plain version: the two
# differ only in how their f32 sums are taken (order, and the tensor cores'
# accumulation) before y is rounded to bf16 once, so an element may differ
# by one bf16 ulp (at most 2^-7 of its value) where the sums straddle a
# rounding boundary, plus an f32 summation slack
SPLIT_ATOL, SPLIT_RTOL = 1e-5, 2.0 ** -7
FLIP_MARGIN = 2e-2              # router-logit gap a bf16 rounding can close
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16
GROUPED_FFN_SM90 = "src/repro_torch/kernels/csrc/grouped_ffn_sm90.cuh"
FLASH_SM90 = "src/repro_torch/kernels/csrc/flash_attention_sm90.cuh"
DECODE_SM90 = "src/repro_torch/kernels/csrc/decode_sm90.cuh"
# the decode kernels' device code (decode_sm90.cuh): a pattern of its mangled
# names, in each of the three decode libraries
DECODE_KERNEL = "decode_sm9013decode_kernel"
DECODE_LIBS = ("paged_decode_attention", "quantized_paged_decode_attention", "decode_attention")


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


# launches of a spin kernel that open each profiler session: a session can
# miss its first launches (seen on the card after serving runs: the first
# 11 of a session's), and these absorb that loss
PRELUDE_LAUNCHES = 40


def open_session(torch) -> None:
    """Launch the prelude of a profiler session and wait for it."""
    for _ in range(PRELUDE_LAUNCHES):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def device_events(prof) -> list:
    """A session's CUDA events (kernels, copies, memsets), but the prelude's."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]


def profiled_kernels(fn, reps: int):
    """torch.profiler over ``reps`` calls of ``fn`` after one warm call:
    the CUDA events (kernels, copies, memsets) of ``key_averages()``, but
    the session's opening spin kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        open_session(torch)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return device_events(prof)


def complete_sessions(fn, reps: int, sessions: int = 3, bound_ms=None):
    """The CUDA events of up to ``sessions`` complete torch.profiler sessions
    of ``reps`` calls of ``fn``, from at most 3 x ``sessions`` tries.  A
    session now and then records only part of the calls' kernels, or none,
    past what its opening launches absorb.  A session is complete when every kernel it recorded ran a multiple of
    ``reps`` times, it recorded as many launches as the most any session
    did, and its time a call is no less than ``bound_ms`` (the least the
    card could take: a shorter reading is a partial record, not a fast
    kernel).  What was discarded is logged."""
    runs = []
    for _ in range(3 * sessions):
        ev = profiled_kernels(fn, reps)
        runs.append((ev, sum(e.count for e in ev), all(e.count % reps == 0 for e in ev),
                     sum(e.self_device_time_total for e in ev) / 1e3 / reps))
        most = max(r[1] for r in runs)
        good = [r for r in runs if r[1] == most and r[2] and r[3] > 0
                and (bound_ms is None or r[3] >= bound_ms)]
        if len(good) >= sessions:
            break
    if len(good) < len(runs):
        log(f"    profiler: kept {len(good)} of {len(runs)} sessions; launches recorded "
            f"{[r[1] for r in runs]} over {reps} calls, device ms a call "
            f"{['%.5f' % r[3] for r in runs]}"
            + ("" if bound_ms is None else f", bound {bound_ms:.5f}"))
    return [r[0] for r in good]


def device_ms(fn, reps: int = 20, sessions: int = 3, bound_ms=None):
    """Device time of one call of ``fn``: the summed CUDA time of everything
    it launches, from torch.profiler, over ``reps`` calls, the median of
    the complete sessions (``complete_sessions``); None (not measured) if
    no session was complete."""
    totals = sorted(sum(e.self_device_time_total for e in ev)
                    for ev in complete_sessions(fn, reps, sessions, bound_ms))
    return totals[len(totals) // 2] / 1e3 / reps if totals else None


def check_close(name: str, got, want, atol: float = TOL, rtol: float = TOL) -> float:
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements off, max abs err "
                             f"{float(err.max()):.4g}")
    tol = f"atol=rtol={atol}" if atol == rtol else f"atol={atol:g}, rtol={rtol:g}"
    log(f"  {name}: max abs err {float(err.max()):.3g} ({tol})")
    return float(err.max())


def on_cuda_cores(ops, fn, route="tensor_core_route"):
    """``fn`` with the kernel wrapper module ``ops`` held to its CUDA-core
    route (the device code before the tensor-core one; ``route`` is the
    module's route function), to time or compare that route at shapes that
    would take the tensor cores."""
    from unittest import mock

    def run(*args):
        with mock.patch.object(ops, route, lambda *a: False):
            return fn(*args)

    return run


def check_routed(name, wrapper, call, args, ref, split_ref, tensor_cores,
                 cuda_core_call=None, split="split-h"):
    """One call ``call(*args)`` of a wrapper with a tensor-core route (the
    grouped FFN, flash attention): the route it took (the ``wrapper``'s
    ``tc_launches`` counter), its output against the plain version at TOL
    and, on the tensor-core route, against the plain version of that
    route's numerics (``split_ref``) at SPLIT_ATOL / SPLIT_RTOL; with
    ``cuda_core_call``, the share of outputs that differ from the plain
    version on each route, on the same inputs.  Returns (max abs err
    against the plain version, against the split one or None)."""
    import torch

    before = wrapper.tc_launches
    out = call(*args)
    torch.cuda.synchronize()
    took = wrapper.tc_launches - before
    if took != int(tensor_cores):
        raise AssertionError(f"{name}: took the {'tensor-core' if took else 'CUDA-core'} route, "
                             f"expected the other")
    route = "tensor cores" if took else "CUDA cores"
    want = ref(*args)
    err = check_close(f"{name} [{route}] vs plain", out, want)
    if cuda_core_call is not None:
        cc = cuda_core_call(*args)
        log(f"    outputs differing from the plain version: "
            f"{float((out != want).float().mean()):.5f} on this route, "
            f"{float((cc != want).float().mean()):.5f} on the CUDA-core route (max abs err "
            f"{float((cc.float() - want.float()).abs().max()):.3g})")
    if not tensor_cores:
        return err, None
    want = split_ref(*args)
    err_split = check_close(f"{name} [{route}] vs {split} plain", out, want,
                            atol=SPLIT_ATOL, rtol=SPLIT_RTOL)
    log(f"    {float((out == want).float().mean()):.4f} of the elements bit-equal to the "
        f"{split} plain version")
    return err, err_split


def ptxas_functions(report: str, pattern: str) -> dict:
    """{mangled kernel name: (registers, spill-store bytes)} from a ptxas -v
    report, for the kernels whose name holds ``pattern``."""
    out = {}
    for block in report.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if pattern not in name:
            continue
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out[name] = (int(regs.group(1)) if regs else -1, int(spill.group(1)) if spill else 0)
    return out


# the tensor-core kernels of each library (a pattern of their mangled names)
TC_KERNELS = {"moe_ffn": "tc_pass_kernel", "ragged_ffn": "tc_pass_kernel",
              "flash_attention": "flash_tc_kernel"}


def check_sass(build) -> None:
    """Every tensor-core kernel (TC_KERNELS: the grouped FFN's
    ``tc_pass_kernel`` in the two FFN libraries, ``flash_tc_kernel``) must
    hold HGMMA (wgmma) instructions in its SASS; without cuobjdump on the
    machine this is logged as not checked."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("  SASS HGMMA check: not checked (no cuobjdump)")
        return
    for name, pattern in TC_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts = {}
        for block in sass.split("Function : ")[1:]:
            fn = block.split(None, 1)[0]
            if pattern in fn:
                counts[fn] = block.count("HGMMA")
        if not counts or min(counts.values()) == 0:
            raise AssertionError(f"{name}: tensor-core kernels without HGMMA in their SASS: "
                                 f"{[f for f, n in counts.items() if n == 0] or 'none found'}")
        log(f"  SASS HGMMA check, {name}: {len(counts)} tensor-core kernels, "
            f"{min(counts.values())}-{max(counts.values())} HGMMA instructions each")


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


def quantize_pools(kp, vp, name):
    """Per-(block, head) absmax int8/fp8 codes and f32 scales of two pools."""
    from repro_torch.quant import get_kv_quant

    pol = get_kv_quant(name)
    out = []
    for x in (kp, vp):
        x = x.float()
        s = x.abs().amax(dim=(2, 3)) / pol.qmax
        out += [pol.encode(x / s.clamp_min(1e-30)[:, :, None, None]).contiguous(),
                s.contiguous()]
    return out                                  # k_codes, k_scales, v_codes, v_scales


def quant_attention_case(N, Hq, Hkv, D, bs, MB, lengths, seed, name, dtype=None):
    """``attention_case`` with its pools quantized: (q, k_codes, v_codes,
    k_scales, v_scales, tables, lengths) in the wrapper's argument order."""
    q, kp, vp, tables, lengths = attention_case(N, Hq, Hkv, D, bs, MB, lengths, seed, dtype)
    kc, ks, vc, vs = quantize_pools(kp, vp, name)
    return q, kc, vc, ks, vs, tables, lengths


def dense_case(B, T, Hq, Hkv, D, lengths, seed, dtype=None, pad_t=0):
    """q (B, Hq, D) and a dense (B, T, Hkv, D) cache; with ``pad_t`` the
    cache is a T-long view of a longer buffer (strided along b)."""
    import torch

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Hq, D), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((B, T + pad_t, Hkv, D), generator=g, device="cuda").to(dtype)[:, :T]
            for _ in range(2))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def ffn_case(n_choices, E, M, I, seed, act="gelu", bx=None, weights=None, groups=1):
    """Expert-sorted rows exactly as the dropless dispatcher builds them
    from a top-1 plan over random router logits, for ``groups`` routing
    groups of ``n_choices`` each (one launch over all groups' rows)."""
    import torch

    from repro_torch.configs.base import MoEConfig
    from repro_torch.core.routers.topk import topk_plan
    from repro_torch.kernels.moe_dropless.ops import pick_block_rows

    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((groups, n_choices, E), generator=g, device="cuda")
    plan = topk_plan(logits, MoEConfig(num_experts=E, top_k=1, aux_loss_coef=0.0),
                     n_choices)
    bx = bx or pick_block_rows(n_choices, E)
    rag = plan.ragged(bx)
    x = torch.randn((groups, n_choices, M), generator=g, device="cuda").to(torch.bfloat16)
    tok = torch.clamp(rag.token, min=0).long()
    xs = torch.cat([x[i][tok[i]] for i in range(groups)]).contiguous()
    if weights is None:
        def w(*shape):
            return (torch.randn(shape, generator=g, device="cuda") * 0.02).to(torch.bfloat16)

        gated = act in ("swiglu", "geglu")
        weights = (w(E, M, I), w(E, M, I) if gated else None, w(E, I, M))
    be = rag.block_expert.reshape(-1).contiguous()
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


def quant_attention_bound(q, kc, tables, lengths):
    """q read and out written once; the codes of the live positions and one
    K and one V scale per live (block, head); the tables and lengths."""
    N, Hq, D = q.shape
    Hkv, bs = kc.shape[1], kc.shape[2]
    live = float(lengths.sum())
    blocks = float(((lengths + bs - 1) // bs).sum())
    nbytes = (2 * q.numel() * q.element_size() + 2 * live * Hkv * D
              + 2 * blocks * Hkv * 4 + tables.numel() * 4 + lengths.numel() * 4)
    return roofline(nbytes, 4.0 * Hq * D * live)


def dense_bound(q, k, lengths):
    """q read and out written once, the valid K/V rows once, the lengths."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    live = float(lengths.clamp(max=k.shape[1]).sum())
    nbytes = (2 * q.numel() * q.element_size() + 2 * live * Hkv * D * k.element_size()
              + lengths.numel() * 4)
    return roofline(nbytes, 4.0 * Hq * D * live)


def ffn_bound(xs, be, weights, rag, bx):
    """Only what this layout's data needs: the live rows of x read and of
    the output written, and the weights of the routed experts.  Blocks
    past ``expert_offsets[E]`` are padding clipped to expert E-1, so they
    add neither rows nor an expert."""
    import torch

    M = xs.shape[1]
    w_up, w_gate, w_down = weights
    I = w_up.shape[2]
    G, nb = rag.block_expert.shape                          # groups, row blocks a group
    blocks = torch.cat([g * nb + torch.arange(int(rag.expert_offsets[g, -1]) // bx,
                                              device=be.device) for g in range(G)])
    used = int(blocks.numel())                              # routed row blocks
    experts = int(be[blocks].unique().numel())              # distinct routed experts
    live = int((rag.token >= 0).sum())                      # real (token, choice) rows
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
    from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref, ragged_ffn_split_ref

    log("phase 3: kernels against their plain versions")
    errs = {"paged_decode_attention": 0.0, "ragged_ffn": 0.0, "ragged_ffn split": 0.0}
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

    def ragged(name, xs, be, weights, act, bx, tensor_cores=True, both=False):
        return check_routed(
            f"ragged_ffn {name}", rffn.ragged_ffn,
            lambda *a: rffn.ragged_ffn(*a, act, block_x=bx), (xs, be, *weights),
            lambda *a: ragged_ffn_ref(*a, act), lambda *a: ragged_ffn_split_ref(*a, act),
            tensor_cores,
            on_cuda_cores(rffn, lambda *a: rffn.ragged_ffn(*a, act, block_x=bx)) if both
            else None)

    weights = None
    for n in (8, 40):                               # decode and mixed steps, bx = 8
        xs, be, weights, rag, bx = ffn_case(n, 32, 1024, 4096, seed=30 + n, weights=weights)
        used = int(rag.expert_offsets[0, -1]) // bx
        log(f"  ragged_ffn n={n}: R={xs.shape[0]} rows, bx={bx}, "
            f"{used} expert blocks + {be.numel() - used} trailing padding blocks")
        err, split = ragged(f"n={n}", xs, be, weights, "gelu", bx, both=True)
        errs["ragged_ffn"] = max(errs["ragged_ffn"], err)
        errs["ragged_ffn split"] = max(errs["ragged_ffn split"], split)
    # the model drafter's full forward: 2 routing groups of 8 x 128 tokens
    # in one launch, the tile width the dispatcher picks for them
    xs, be, _, rag, bx = ffn_case(1024, 32, 1024, 4096, seed=150, weights=weights, groups=2)
    log(f"  ragged_ffn model drafter: R={xs.shape[0]} rows in 2 groups, bx={bx}")
    err, split = ragged("model drafter", xs, be, weights, "gelu", bx)
    errs["ragged_ffn"] = max(errs["ragged_ffn"], err)
    errs["ragged_ffn split"] = max(errs["ragged_ffn split"], split)
    del xs, be, rag
    xs, be, w128, _, bx = ffn_case(300, 8, 512, 1024, seed=50, bx=128)   # bx = 128
    ragged("bx=128", xs, be, w128, "gelu", bx)
    xs, be, wsw, _, bx = ffn_case(40, 8, 256, 512, seed=60, act="swiglu")
    ragged("swiglu", xs, be, wsw, "swiglu", bx)
    ragged("swiglu f32", xs.float(), be, [w.float() for w in wsw], "swiglu", bx,
           tensor_cores=False)
    errs.update(check_training_kernels(torch))
    errs.update(check_decode_kernels(torch))
    check_paged_design(torch)
    check_dense_design(torch)
    return errs, weights


def check_paged_design(torch):
    """The paged kernels' cases of their Hopper design (bulk copies into a
    ring of stages, a split over a thread-block cluster), for the bf16/f32
    kernel and the int8/fp8 one, each against its plain version at TOL with
    length-0 rows exactly 0: every splits in (1, 2, 4, 8) forced at the m6
    serving shape; a ring that wraps (bs 16, MB 64, a 1000-token row) at
    splits 1 and 2; f32 at G in (2, 4, 8) and D in
    (32, 128); and a garbage block (the table's entry past each length)
    filled with 1e4 / -1e4, which must not reach the output; one-position
    blocks, whose passes span more blocks than the ring holds."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref,
        quantized_paged_decode_attention_ref,
    )
    from repro_torch.quant import get_kv_quant

    def run(label, case, fmt=None, splits=None):
        if fmt is None:
            out = da.paged_decode_attention(*case, splits=splits)
            want = paged_decode_attention_ref(*case)
            plan = da.launch_plan(case[0], case[1], case[3], splits)
        else:
            pol = get_kv_quant(fmt)
            out = da.quantized_paged_decode_attention(*case, policy=pol, splits=splits)
            want = quantized_paged_decode_attention_ref(*case, policy=pol)
            plan = da.launch_plan(case[0], case[1], case[5], splits)
        torch.cuda.synchronize()
        N, Hq, D = case[0].shape
        Hkv, bs = case[1].shape[1], case[1].shape[2]
        name = (f"{'paged' if fmt is None else fmt} {label} N={N} G={Hq // Hkv} D={D} bs={bs} "
                f"MB={case[-2].shape[1]} {str(case[0].dtype)[6:]} splits={plan[0]} "
                f"stages={plan[1]}")
        check_close(name, out, want)
        if not (out[case[-1] == 0] == 0).all():
            raise AssertionError(f"{name}: a length-0 row is not exactly 0")

    m6_lens = [40, 0, 17, 256, 1, 100, 16, 63]
    for splits in (1, 2, 4, 8):
        run("forced", attention_case(8, 16, 16, 64, 16, 16, m6_lens, seed=500), splits=splits)
        for fmt in ("int8", "fp8"):
            run("forced", quant_attention_case(8, 16, 16, 64, 16, 16, m6_lens, seed=501,
                                               name=fmt), fmt, splits=splits)
    wrap_lens = [1000, 0, 37]
    for splits in (1, 2):
        run("ring wraps", attention_case(3, 16, 16, 64, 16, 64, wrap_lens, seed=510),
            splits=splits)
        run("ring wraps", quant_attention_case(3, 16, 16, 64, 16, 64, wrap_lens, seed=511,
                                               name="int8"), "int8", splits=splits)
    # one-position blocks: a pass spans more blocks than the ring holds
    run("bs=1 ring wraps", attention_case(2, 4, 4, 32, 1, 64, [64, 37], seed=512))
    run("bs=1 ring wraps", quant_attention_case(2, 4, 4, 32, 1, 64, [64, 37], seed=513,
                                                name="int8"), "int8")
    lens = [5, 0, 31, 33, 200]
    for i, (Hq, Hkv, D) in enumerate(((16, 8, 32), (16, 4, 128), (16, 2, 128), (8, 1, 32))):
        run("f32", attention_case(5, Hq, Hkv, D, 16, 16, lens, seed=520 + i,
                                  dtype=torch.float32))
        run("f32", quant_attention_case(5, Hq, Hkv, D, 16, 16, lens, seed=530 + i,
                                        name=("int8", "fp8")[i % 2], dtype=torch.float32),
            ("int8", "fp8")[i % 2])
    q, kp, vp, tables, lengths = attention_case(8, 16, 16, 64, 16, 16, m6_lens, seed=540)
    kp[-1], vp[-1] = 1e4, -1e4                    # the garbage block: every table's tail
    run("garbage block", (q, kp, vp, tables, lengths))
    q, kc, vc, ks, vs, tables, lengths = quant_attention_case(8, 16, 16, 64, 16, 16, m6_lens,
                                                              seed=541, name="int8")
    kc[-1], vc[-1], ks[-1], vs[-1] = 127, -127, 1e4, 1e4
    run("garbage block", (q, kc, vc, ks, vs, tables, lengths), "int8")


def check_dense_design(torch):
    """The dense kernel's cases of its Hopper design (TMA boxes of a tensor
    map into a ring of stages, the first pass's issued before the length
    is read; a split over a thread-block cluster), against its plain version at TOL with
    length-0 rows exactly 0: every splits in (1, 2, 4, 8) forced at the m6
    shape (plan from T and from the longest length); a ring that wraps (a
    1000-position row of a 1024-position cache) at splits 1 and 2; f32 at
    G in (2, 4, 8) and D in (32, 128), and bf16 at D = 16; cache rows past
    every length filled with 1e4 / -1e4, which must not reach the output
    (the kernel fetches its first pass's tiles whatever the length)."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    def run(label, case, splits=None, max_length=None):
        q, k = case[0], case[1]
        out = da.decode_attention(*case, splits=splits, max_length=max_length)
        torch.cuda.synchronize()
        B, Hq, D = q.shape
        T, Hkv = k.shape[1], k.shape[2]
        plan = da.dense_plan(B, Hkv, Hq // Hkv, D, T, q.element_size(),
                             da._sm_count(q.device.index), splits, max_length)
        name = (f"dense {label} B={B} T={T} G={Hq // Hkv} D={D} {str(q.dtype)[6:]} "
                f"splits={plan[0]} stages={plan[1]}")
        check_close(name, out, decode_attention_ref(*case))
        if not (out[case[3] == 0] == 0).all():
            raise AssertionError(f"{name}: a length-0 row is not exactly 0")

    m6_lens = [40, 0, 17, 256, 1, 100, 16, 63]
    for splits in (1, 2, 4, 8):
        run("forced", dense_case(8, 256, 16, 16, 64, m6_lens, seed=600), splits=splits)
        run("forced, longest known", dense_case(8, 256, 16, 16, 64, m6_lens, seed=601),
            splits=splits, max_length=max(m6_lens))
    for splits in (1, 2):
        run("ring wraps", dense_case(3, 1024, 16, 16, 64, [1000, 0, 37], seed=610),
            splits=splits)
    lens = [5, 0, 31, 33, 200]
    for i, (Hq, Hkv, D) in enumerate(((16, 8, 32), (16, 4, 128), (16, 2, 128), (8, 1, 32))):
        run("f32", dense_case(5, 208, Hq, Hkv, D, lens, seed=620 + i, dtype=torch.float32))
    run("D=16", dense_case(5, 208, 16, 4, 16, lens, seed=630))
    q, k, v, lengths = dense_case(8, 256, 16, 16, 64, m6_lens, seed=640)
    past = torch.arange(256, device="cuda")[None, :] >= lengths[:, None]   # (B, T)
    k[past], v[past] = 1e4, -1e4
    for splits in (None, 1, 4):
        run("1e4 past the lengths", (q, k, v, lengths), splits=splits)


def check_training_kernels(torch):
    """The grouped-FFN kernel at the training path's capacity buffers (top-1:
    X = 45, 4 top-1: X = 180) and the reference's edge cases; the flash
    kernel at the m6 training shapes (S = 144, 256) and at non-power-of-two
    and ragged S, S = 1, Hkv < Hq, non-causal and f32, each on the route
    its type and width select, the tensor-core route also within one bf16
    ulp of its plain version (P as bf16 hi + lo)."""
    from repro_torch.kernels.common import flash_tensor_core_route
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref, attention_split_ref
    from repro_torch.kernels.moe_ffn import ops as mf
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref, moe_ffn_split_ref

    def moe(name, case, act, tensor_cores=True, both=False):
        return check_routed(
            f"moe_ffn {name}", mf.moe_ffn, lambda *a: mf.moe_ffn(*a, act), case,
            lambda *a: moe_ffn_ref(*a, act), lambda *a: moe_ffn_split_ref(*a, act), tensor_cores,
            on_cuda_cores(mf, lambda *a: mf.moe_ffn(*a, act)) if both else None)

    errs = {"moe_ffn": 0.0, "moe_ffn split": 0.0}
    for X in (45, 180):
        case = moe_case(32, X, 1024, 4096, seed=90 + X)
        err, split = moe(f"E=32 X={X}", case, "gelu", both=True)
        errs["moe_ffn"] = max(errs["moe_ffn"], err)
        errs["moe_ffn split"] = max(errs["moe_ffn split"], split)
        del case
    # the CUDA-core route (f32; I % 8 != 0 in bf16 and f32) and the
    # tensor-core route's tiles (one N = 128 tile of X = 100; two of 192;
    # three gated tiles of 128; one gated tile of 128 under geglu)
    for E, X, M, I, act, dt, tc in ((1, 100, 64, 40, "swiglu", torch.float32, False),
                                    (2, 100, 64, 96, "gelu", torch.bfloat16, True),
                                    (3, 13, 128, 44, "relu", torch.float32, False),
                                    (3, 13, 128, 44, "relu", torch.bfloat16, False),
                                    (2, 300, 64, 128, "gelu", torch.bfloat16, True),
                                    (4, 300, 256, 512, "swiglu", torch.bfloat16, True),
                                    (3, 128, 128, 256, "geglu", torch.bfloat16, True)):
        case = moe_case(E, X, M, I, seed=E + X + I, act=act, dtype=dt)
        moe(f"E={E} X={X} M={M} I={I} {act} {str(dt)[6:]}", case, act, tc)
    # flash: the m6 training shape (both routes compared), the CUDA-core
    # route (f32; D = 16, 32), and the tensor-core route's edges: D = 128
    # with Hkv < Hq, S = 1, a ragged S = 17, the longest m6 S = 256
    for B, S, Hq, Hkv, D, causal, dt in ((8, 144, 16, 16, 64, True, torch.bfloat16),
                                         (2, 80, 4, 1, 128, False, torch.float32),
                                         (1, 96, 8, 1, 16, True, torch.float32),
                                         (2, 96, 4, 2, 32, False, torch.bfloat16),
                                         (2, 80, 8, 2, 128, False, torch.bfloat16),
                                         (2, 1, 4, 2, 64, True, torch.bfloat16),
                                         (2, 17, 4, 4, 64, False, torch.bfloat16),
                                         (8, 256, 16, 16, 64, True, torch.bfloat16)):
        q, k, v = flash_case(B, S, Hq, Hkv, D, seed=S + D)
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        tc = flash_tensor_core_route(dt, D)

        def flash(q, k, v, causal=causal):
            return fa.flash_attention(q, k, v, causal=causal)

        err, split = check_routed(
            f"flash_attention B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
            f"{'causal' if causal else 'full'} {str(dt)[6:]}", fa.flash_attention, flash,
            (q, k, v), lambda *a: attention_ref(*a, causal),
            lambda *a: attention_split_ref(*a, causal), tc,
            on_cuda_cores(fa, flash, "flash_tensor_core_route") if S == 144 else None,
            split="split-P")
        if S == 144:
            errs["flash_attention"], errs["flash_attention split"] = err, split
    return errs


def check_decode_kernels(torch):
    """The quantized paged kernel (int8 and fp8 codes) at the m6 serving
    shape with bf16 q, and with f32 q at G = 2, 4 and 8 and D = 32 and 128;
    the dense kernel at tests/test_kernels.py's DECODE_CASES shapes and the
    m6 shape (read as a strided view); length-0 rows exactly 0 in both; and
    quant_write_kv's codes and scales on the card against the CPU's."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref,
        quantized_paged_decode_attention_ref,
    )
    from repro_torch.quant import get_kv_quant, quant_write_kv

    errs = {"quantized_paged_decode_attention": 0.0, "decode_attention": 0.0}
    m6_lens = [40, 0, 17, 256, 1, 100, 16, 63]
    cases = [("int8", (8, 16, 16, 64, 16, 16, m6_lens), None),
             ("fp8", (8, 16, 16, 64, 16, 16, m6_lens), None),
             ("int8", (40, 16, 16, 64, 16, 16, list(range(17, 49)) + [0] * 8), None),
             ("int8", (6, 16, 8, 64, 16, 16, [5, 0, 31, 33, 200, 256]), torch.float32),
             ("fp8", (6, 16, 4, 64, 16, 16, [5, 0, 31, 33, 200, 256]), torch.float32),
             ("fp8", (3, 16, 2, 128, 16, 8, [0, 77, 128]), torch.float32),
             ("int8", (4, 4, 4, 32, 8, 8, [0, 9, 64, 3]), torch.float32)]
    for i, (name, shape, dt) in enumerate(cases):
        case = quant_attention_case(*shape, seed=200 + i, name=name, dtype=dt)
        pol = get_kv_quant(name)
        out = da.quantized_paged_decode_attention(*case, policy=pol)
        torch.cuda.synchronize()
        N, Hq, Hkv, D = shape[:4]
        label = (f"quantized_paged_decode_attention {name} N={N} G={Hq // Hkv} D={D} "
                 f"bs={shape[4]} {str(case[0].dtype)[6:]}")
        err = check_close(label, out, quantized_paged_decode_attention_ref(*case, policy=pol))
        if case[0].dtype == torch.bfloat16:
            errs["quantized_paged_decode_attention"] = max(
                errs["quantized_paged_decode_attention"], err)
        if not (out[case[6] == 0] == 0).all():
            raise AssertionError(f"{label}: a length-0 row is not exactly 0")

    dense = [(2, 128, 8, 2, 32, torch.float32), (1, 96, 4, 4, 16, torch.float32),
             (3, 256, 8, 1, 64, torch.bfloat16), (2, 80, 2, 2, 128, torch.float32),
             (8, 256, 16, 16, 64, torch.bfloat16)]
    for i, (B, T, Hq, Hkv, D, dt) in enumerate(dense):
        g = torch.Generator().manual_seed(300 + i)
        lens = torch.randint(1, T + 1, (B,), generator=g).tolist()
        if B > 1:
            lens[0], lens[-1] = 0, T
        case = dense_case(B, T, Hq, Hkv, D, lens, seed=300 + i, dtype=dt,
                          pad_t=44 if B == 8 else 0)
        out = da.decode_attention(*case)
        torch.cuda.synchronize()
        label = f"decode_attention B={B} T={T} Hq={Hq} Hkv={Hkv} D={D} {str(dt)[6:]}"
        err = check_close(label, out, decode_attention_ref(*case))
        if B == 8:
            errs["decode_attention"] = err
        if B > 1 and not (out[0] == 0).all():
            raise AssertionError(f"{label}: the length-0 row is not exactly 0")

    # quant_write_kv: engine-like writes (a 32-row chunk over three blocks,
    # decode rows, masked rows into the garbage block) at m6 widths
    g = torch.Generator().manual_seed(400)
    P, Hkv, bs, D = 12, 16, 16, 64
    for name in ("int8", "fp8"):
        pol = get_kv_quant(name)
        dev = [torch.zeros((P, Hkv, bs, D), dtype=torch.int8, device="cuda"),
               torch.zeros((P, Hkv), device="cuda")]
        cpu = [t.cpu() for t in dev]
        for step in range(6):
            wb = torch.tensor([step % 3] * 2 + [3 + step // 2, 4 + (step + 1) // 2, 11, 11],
                              dtype=torch.int32)
            wo = torch.tensor([(2 * step) % bs, (2 * step + 1) % bs, (5 * step) % bs,
                               (3 * step + 1) % bs, 0, 0], dtype=torch.int32)
            x = torch.randn((6, Hkv, D), generator=g) * (1 + 10 * step)
            x[5] = x[4]                                  # masked rows carry one value
            quant_write_kv(*dev, x.cuda(), wb.cuda(), wo.cuda(), policy=pol)
            quant_write_kv(*cpu, x, wb, wo, policy=pol)
        torch.cuda.synchronize()
        if not (torch.equal(dev[0].cpu(), cpu[0])
                and torch.equal(dev[1].cpu().view(torch.int32), cpu[1].view(torch.int32))):
            raise AssertionError(f"quant_write_kv {name}: codes or scales on the card "
                                 f"differ from the CPU's")
        log(f"  quant_write_kv {name}: codes and scale bits on the card equal the CPU's "
            f"after 6 steps")
    return errs


def time_quantized(torch, lens, seed, name="int8"):
    """Kernel, plain and dequantize-then-SDPA times for one quantized paged
    attention call at the m6 decode shape (16 rotating copies)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import quantized_paged_decode_attention_ref
    from repro_torch.quant import get_kv_quant

    pol = get_kv_quant(name)
    copies = [quant_attention_case(len(lens), 16, 16, 64, 16, 16, lens, seed=seed + c,
                                   name=name) for c in range(16)]
    it = iter(range(1 << 30))

    def nxt():
        return copies[next(it) % len(copies)]

    def kern():                                   # the engine passes its longest row
        return da.quantized_paged_decode_attention(*nxt(), policy=pol, max_length=max(lens))

    q, kc, vc, ks, vs, tables, lengths = copies[0]
    bound, by = quant_attention_bound(q, kc, tables, lengths)
    k_ms, k_dev = cuda_ms(kern), device_ms(kern, bound_ms=bound)
    p_ms = cuda_ms(lambda: quantized_paged_decode_attention_ref(*nxt(), policy=pol))
    N, Hq, D = q.shape
    Hkv, bs, MB = kc.shape[1], kc.shape[2], tables.shape[1]
    tbl = tables.long()
    mask = (torch.arange(MB * bs, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]

    def dequant_sdpa():
        k = (pol.decode(kc[tbl]) * ks[tbl][..., None, None]).to(q.dtype)
        v = (pol.decode(vc[tbl]) * vs[tbl][..., None, None]).to(q.dtype)
        k = k.permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
        v = v.permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
        return F.scaled_dot_product_attention(q[:, :, None, :], k, v, attn_mask=mask)

    lib_ms, lib_dev = cuda_ms(dequant_sdpa), device_ms(dequant_sdpa, bound_ms=bound)
    return dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=lib_ms,
                library_device_ms=lib_dev, bound_ms=bound, bound_by=by,
                plan=da.launch_plan(q, kc, tables, max_length=max(lens)))


def dense_sdpa(q, k, v, lengths):
    """SDPA with a length mask over the dense cache read in place (its
    (B, Hkv, T, D) view): the library call for dense decode."""
    import torch
    import torch.nn.functional as F

    T = k.shape[1]
    mask = (torch.arange(T, device=k.device)[None, :] < lengths[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q[:, :, None, :], k.transpose(1, 2),
                                                  v.transpose(1, 2), attn_mask=mask)


def time_dense(torch, lens, seed, T=256):
    """Kernel, plain and SDPA (length mask) times for one dense decode call
    at the m6 shape, B = len(lens), 16 rotating copies; the caller knows
    the longest length, as a decode step's host does."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    copies = [dense_case(len(lens), T, 16, 16, 64, lens, seed=seed + c) for c in range(16)]
    it = iter(range(1 << 30))

    def nxt():
        return copies[next(it) % len(copies)]

    def kern():
        return da.decode_attention(*nxt(), max_length=max(lens))

    q, k, v, lengths = copies[0]
    bound, by = dense_bound(q, k, lengths)
    k_ms, k_dev = cuda_ms(kern), device_ms(kern, bound_ms=bound)
    p_ms = cuda_ms(lambda: decode_attention_ref(*nxt()))
    sdpa = dense_sdpa(q, k, v, lengths)
    return dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=cuda_ms(sdpa),
                library_device_ms=device_ms(sdpa, bound_ms=bound), bound_ms=bound, bound_by=by,
                plan=da.dense_plan(len(lens), 16, 1, 64, T, 2, da._sm_count(0),
                                   max_length=max(lens)))


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

    def kern():                                   # the engine passes its longest row
        return pda.paged_decode_attention(*nxt(), max_length=max(lens))

    q, kp, vp, tables, lengths = copies[0]
    bound, by = attention_bound(q, kp, tables, lengths)
    k_ms, k_dev = cuda_ms(kern), device_ms(kern, bound_ms=bound)
    p_ms = cuda_ms(lambda: paged_decode_attention_ref(*nxt()))
    N, Hq, D = q.shape
    Hkv, bs, MB = kp.shape[1], kp.shape[2], tables.shape[1]
    kk = kp[tables.long()].permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    vv = vp[tables.long()].permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    mask = (torch.arange(MB * bs, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None, :], kk, vv, attn_mask=mask)

    kernels = sorted(profiled_kernels(sdpa, 4), key=lambda e: -e.self_device_time_total)
    log(f"  SDPA at N={N} launches: " + "; ".join(
        f"{e.key[:90]} ({e.self_device_time_total / 4e3:.5f} ms)" for e in kernels))
    return dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=cuda_ms(sdpa),
                library_device_ms=device_ms(sdpa, bound_ms=bound), bound_ms=bound, bound_by=by,
                plan=pda.launch_plan(q, kp, tables, max_length=max(lens)))


def time_splits(torch, decode_lens, seed=120):
    """Device time of the paged (bf16), int8 and dense kernels at 8 rows of
    256 positions and at the decode step's lengths, for the wrapper's own
    splits (given the longest length, as the engine gives it) and for each
    of (1, 2, 4, 8) forced, over 16 rotating copies, with the splits and
    stages of each launch, and SDPA's device time on the dense cache beside
    the dense kernel's: {label: {kernel: [(splits, stages, chosen, device
    ms), ...], "decode_attention sdpa": ms, "decode_attention bound": ms}}."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.quant import get_kv_quant

    pol = get_kv_quant("int8")
    sms = da._sm_count(0)
    out = {}
    for label, lens in (("8 rows x 256 positions", [256] * 8), ("decode (N=8)", decode_lens)):
        bf = [attention_case(8, 16, 16, 64, 16, 16, lens, seed=seed + c) for c in range(16)]
        i8 = [quant_attention_case(8, 16, 16, 64, 16, 16, lens, seed=seed + c, name="int8")
              for c in range(16)]
        dn = [dense_case(8, 256, 16, 16, 64, lens, seed=seed + c) for c in range(16)]
        longest = max(lens)                       # as the engine passes it
        kernels = {"paged_decode_attention": (
                       bf, lambda c, s: da.paged_decode_attention(*c, splits=s,
                                                                  max_length=longest),
                       lambda c, s: da.launch_plan(c[0], c[1], c[3], s, longest),
                       attention_bound(bf[0][0], bf[0][1], bf[0][3], bf[0][4])[0]),
                   "quantized_paged_decode_attention int8": (
                       i8, lambda c, s: da.quantized_paged_decode_attention(
                           *c, policy=pol, splits=s, max_length=longest),
                       lambda c, s: da.launch_plan(c[0], c[1], c[5], s, longest),
                       quant_attention_bound(i8[0][0], i8[0][1], i8[0][5], i8[0][6])[0]),
                   "decode_attention": (
                       dn, lambda c, s: da.decode_attention(*c, splits=s, max_length=longest),
                       lambda c, s: da.dense_plan(8, 16, 1, 64, 256, 2, sms, s, longest),
                       dense_bound(dn[0][0], dn[0][1], dn[0][3])[0])}
        out[label] = {}
        for name, (copies, call, plan, bound) in kernels.items():
            rows = []
            for forced in (None, 1, 2, 4, 8):
                it = iter(range(1 << 30))

                def fn():
                    return call(copies[next(it) % 16], forced)

                cuda_ms(fn, reps=100)                 # warm, as phase 4's other timings
                ms = device_ms(fn, bound_ms=bound)
                splits, stages = plan(copies[0], forced)
                rows.append((splits, stages, forced is None, ms))
                log(f"  {label} {name}: splits {splits}{' (chosen)' if forced is None else ''}"
                    f", stages {stages}: device {fmt_ms(ms)} ms")
            out[label][name] = rows
        sdpa = dense_sdpa(*dn[0])
        cuda_ms(sdpa, reps=100)
        out[label]["decode_attention bound"] = kernels["decode_attention"][3]
        out[label]["decode_attention sdpa"] = device_ms(
            sdpa, bound_ms=out[label]["decode_attention bound"])
        log(f"  {label} decode_attention: SDPA (length mask) device "
            f"{fmt_ms(out[label]['decode_attention sdpa'])} ms, bound "
            f"{out[label]['decode_attention bound']:.5f} ms")
        del bf, i8, dn
    return out


def pass_ms(torch, fn, reps: int = 10, bound_ms=None) -> dict:
    """Device time of each pass of the tensor-core grouped FFN in one call
    of ``fn`` (torch.profiler, the median of the complete sessions):
    {"up": ms, "down": ms}, from the kernels ``tc_pass_kernel<N, KIND>``
    (KIND 0, 1: the up pass; 2: the down pass); None where no session was
    complete."""
    per = []
    for ev in complete_sessions(fn, reps, bound_ms=bound_ms):
        out = {"up": 0.0, "down": 0.0}
        for e in ev:
            m = re.search(r"tc_pass_kernel<\d+, (\d)>", e.key)
            if m:
                out["down" if m.group(1) == "2" else "up"] += e.self_device_time_total / 1e3 / reps
        per.append(out)
    return {k: sorted(p[k] for p in per)[len(per) // 2] if per else None
            for k in ("up", "down")}


def time_ffn(torch, n, seed, weights, groups=1):
    """Kernel, plain and grouped_mm times for one ragged FFN call at the
    dispatcher's layout for ``n`` routed choices over 32 experts (in each
    of ``groups`` routing groups)."""
    import torch.nn.functional as F

    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref

    xs, be, weights, rag, bx = ffn_case(n, 32, 1024, 4096, seed=seed, weights=weights,
                                        groups=groups)

    def kern():
        return rffn.ragged_ffn(xs, be, *weights, "gelu", block_x=bx)

    bound, by = ffn_bound(xs, be, weights, rag, bx)
    k_ms, k_dev = cuda_ms(kern), device_ms(kern, bound_ms=bound)
    cc_ms = cuda_ms(on_cuda_cores(rffn, kern))
    p_ms = cuda_ms(lambda: ragged_ffn_ref(xs, be, *weights, "gelu"), reps=5)
    lib_ms = lib_dev = None
    offs = rag.expert_offsets[0, 1:].contiguous()
    w_up, _, w_down = weights
    try:
        if groups > 1:
            raise ValueError(f"one set of expert offsets, the launch holds {groups} groups")

        def grouped():
            h = F.gelu(F.grouped_mm(xs, w_up, offs=offs), approximate="tanh")
            return F.grouped_mm(h, w_down, offs=offs)

        live = int(offs[-1])
        ref = ragged_ffn_ref(xs, be, *weights, "gelu")
        if (grouped()[:live].float() - ref[:live].float()).abs().max() <= TOL * 4:
            lib_ms, lib_dev = cuda_ms(grouped), device_ms(grouped, bound_ms=bound)
        else:
            log("  grouped_mm yardstick disagrees with the plain version: not timed")
    except (RuntimeError, TypeError, ValueError) as exc:
        log(f"  grouped_mm does not take these shapes ({type(exc).__name__}: "
            f"{str(exc).splitlines()[0][:160]}): library_ms null")
    return dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=lib_ms,
                library_device_ms=lib_dev, bound_ms=bound, bound_by=by, cuda_core_ms=cc_ms,
                pass_ms=pass_ms(torch, kern, bound_ms=bound))


def time_moe_ffn(torch, X, seed):
    """Kernel, plain and bf16 torch.bmm times for one grouped FFN call on
    the capacity buffers of one m6-base layer (E = 32, M = 1024,
    I = 4096, gelu): the weights are 537 MB, far above the 50 MB L2, so
    every launch reads them cold."""
    import torch.nn.functional as F

    from repro_torch.kernels.moe_ffn import ops as mf
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref

    x, w_up, _, w_down = moe_case(32, X, 1024, 4096, seed=seed)
    def kern():
        return mf.moe_ffn(x, w_up, None, w_down, "gelu")

    def bmm():
        return torch.bmm(F.gelu(torch.bmm(x, w_up), approximate="tanh"), w_down)

    k_ms = cuda_ms(kern, reps=10)
    cc_ms = cuda_ms(on_cuda_cores(mf, kern), reps=5)
    p_ms = cuda_ms(lambda: moe_ffn_ref(x, w_up, None, w_down, "gelu"), reps=5)
    lib_ms = cuda_ms(bmm, reps=10)
    bound, by = moe_ffn_bound(x, w_up, None)
    return dict(ms=k_ms, device_ms=device_ms(kern, reps=10, bound_ms=bound), plain_ms=p_ms,
                library_ms=lib_ms, library_device_ms=device_ms(bmm, reps=10, bound_ms=bound),
                bound_ms=bound, bound_by=by, cuda_core_ms=cc_ms,
                pass_ms=pass_ms(torch, kern, bound_ms=bound))


def time_flash(torch, B, S, H, D, seed, copies=16):
    """One causal attention call at an m6 training shape, all in this call:
    the tensor-core kernel (the wrapper's route), the CUDA-core kernel, the
    plain version and SDPA, each by CUDA events over back-to-back calls and
    (but the plain version) by the profiler's device time.  The calls
    rotate over ``copies`` sets of inputs (16 x 7.1 MB at S = 144, more
    than the 50 MB L2), so each reads its inputs from device memory, as
    the bound counts them; the kernel's and SDPA's device times on one set
    read again and again (from L2) are kept beside them as ``warm``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref

    sets = [flash_case(B, S, H, H, D, seed=seed + c) for c in range(copies)]
    it = iter(range(1 << 30))

    def nxt():
        return sets[next(it) % copies]

    def kern(qkv=None):
        q, k, v = qkv or nxt()
        return fa.flash_attention(q, k, v, causal=True)

    def sdpa(qkv=None):
        q, k, v = qkv or nxt()
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True)

    cc = on_cuda_cores(fa, kern, "flash_tensor_core_route")
    bound, by = flash_bound(*sets[0][:2], True)
    out = dict(ms=cuda_ms(kern), device_ms=device_ms(kern, bound_ms=bound),
               cuda_core_ms=cuda_ms(cc), cuda_core_device_ms=device_ms(cc, bound_ms=bound),
               plain_ms=cuda_ms(lambda: attention_ref(*nxt(), True)),
               library_ms=cuda_ms(sdpa), library_device_ms=device_ms(sdpa, bound_ms=bound),
               warm_device_ms=device_ms(lambda: kern(sets[0])),
               library_warm_device_ms=device_ms(lambda: sdpa(sets[0])))
    kernels = sorted(profiled_kernels(sdpa, 4), key=lambda e: -e.self_device_time_total)
    log(f"  SDPA at S={S} launches: " + "; ".join(
        f"{e.key[:90]} ({e.self_device_time_total / 4e3:.5f} ms)" for e in kernels))
    out["bound_ms"], out["bound_by"] = bound, by
    return out


def phase_timing_training(torch):
    """The training kernels at the training path's shapes: the grouped FFN
    at X = 45 (top-1, the JSON line) and X = 180 (4 top-1), flash at B = 8,
    H = 16, D = 64, S = 144 (the JSON line) and S = 256 (the learned
    positions' limit)."""
    out = {"moe_ffn": time_moe_ffn(torch, 45, seed=100),
           "moe_ffn X=180": time_moe_ffn(torch, 180, seed=101),
           "flash_attention": time_flash(torch, 8, 144, 16, 64, seed=102),
           "flash_attention S=256": time_flash(torch, 8, 256, 16, 64, seed=103)}
    for name, r in out.items():
        log(f"  train {name}: {timing_line(r)}")
        if "warm_device_ms" in r:
            log(f"    inputs read again from L2 (warm): kernel {fmt_ms(r['warm_device_ms'])} ms, "
                f"library {fmt_ms(r['library_warm_device_ms'])} ms (device)")
    return out


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.5f}"


def timing_line(r) -> str:
    """A kernel's times: CUDA events over back-to-back calls (which at a
    few microseconds a call read the host's launch rate) and the
    profiler's device time, for the kernel, its CUDA-core route where it
    has one, the plain version and the library call, and the bound."""
    cc = ""
    if "cuda_core_ms" in r:
        cc = f", CUDA-core route {r['cuda_core_ms']:.4f} ms"
        if "cuda_core_device_ms" in r:
            cc += f" (device {fmt_ms(r['cuda_core_device_ms'])})"
    if "pass_ms" in r:
        cc += (f", passes {fmt_ms(r['pass_ms']['up'])} + {fmt_ms(r['pass_ms']['down'])} ms "
               f"(device)")
    if "plan" in r:
        cc += f", splits {r['plan'][0]}, stages {r['plan'][1]}"
    lib = "null" if r["library_ms"] is None else (f"{r['library_ms']:.4f} ms (device "
                                                  f"{fmt_ms(r['library_device_ms'])})")
    return (f"kernel {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}){cc}, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")


def phase_timing(torch, ffn_weights):
    """The serving kernels at the decode step's shapes (8 rows: the JSON
    line) and at the mixed step's (8 decode rows + a 32-row prefill chunk);
    at the decode shape also the quantized kernel over fp8 codes and the
    dense-cache kernel (8 sequences of a 256-position cache)."""
    log("phase 4: timing")
    decode_lens = [21, 56, 112, 9, 74, 33, 98, 47]
    mixed_lens = decode_lens + list(range(17, 49))        # chunk rows of one prompt
    shapes = {"decode (N=8)": (decode_lens, 8), "mixed (N=40)": (mixed_lens, 40)}
    out = {}
    for label, (lens, n) in shapes.items():
        out[label] = {"paged_decode_attention": time_attention(torch, lens, seed=70),
                      "ragged_ffn": time_ffn(torch, n, seed=80, weights=ffn_weights),
                      "quantized_paged_decode_attention": time_quantized(torch, lens, seed=90)}
    out["decode (N=8)"]["quantized_paged_decode_attention fp8"] = time_quantized(
        torch, decode_lens, seed=90, name="fp8")
    out["decode (N=8)"]["decode_attention"] = time_dense(torch, decode_lens, seed=110)
    for label, res in out.items():
        for name, r in res.items():
            log(f"  {label} {name}: {timing_line(r)}")
    out["decode (N=8)"]["splits"] = time_splits(torch, decode_lens)
    return out["decode (N=8)"], out["mixed (N=40)"]


def remeasure(torch, timing, ffn_weights):
    """The device times of the kernels this PR's shared-header change could
    move (the ragged and grouped FFN and flash include sm90.cuh) and of
    the dense decode kernel, measured again on the same inputs as phase 4's
    first measurement: {name: (first, again, again / first)}."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_ffn import ops as mf

    xs, be, weights, _, bx = ffn_case(8, 32, 1024, 4096, seed=80, weights=ffn_weights)
    x, w_up, _, w_down = moe_case(32, 45, 1024, 4096, seed=100)
    sets = [flash_case(8, 144, 16, 16, 64, seed=102 + c) for c in range(16)]
    dense = [dense_case(8, 256, 16, 16, 64, [21, 56, 112, 9, 74, 33, 98, 47], seed=110 + c)
             for c in range(16)]
    it = iter(range(1 << 30))
    calls = {
        "ragged_ffn": (lambda: rffn.ragged_ffn(xs, be, *weights, "gelu", block_x=bx), 20),
        "moe_ffn": (lambda: mf.moe_ffn(x, w_up, None, w_down, "gelu"), 10),
        "flash_attention": (lambda: fa.flash_attention(*sets[next(it) % 16], causal=True), 20),
        "decode_attention": (lambda: da.decode_attention(*dense[next(it) % 16],
                                                         max_length=112), 20),
    }
    out = {}
    for name, (fn, reps) in calls.items():
        cuda_ms(fn, reps=reps)                        # warm, as in phase 4
        ms = device_ms(fn, reps=reps, bound_ms=timing[name]["bound_ms"])
        first = timing[name]["device_ms"]
        ratio = ms / first if ms and first else None
        out[name] = (first, ms, ratio)
        log(f"  re-measure {name}: device {fmt_ms(first)} ms in phase 4, {fmt_ms(ms)} ms again"
            f" ({'not measured' if ratio is None else f'{ratio:.4f}x'})")
    return out


@contextmanager
def plain_versions():
    """Route the forward through the kernels' plain PyTorch versions."""
    from unittest import mock

    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref,
        quantized_paged_decode_attention_ref,
    )
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref

    import repro_torch.kernels.flash_attention as fa_pkg
    import repro_torch.kernels.moe_ffn as mf_pkg
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref

    def plain_ffn(x, be, up, gate, down, activation="swiglu", block_x=128):
        return ragged_ffn_ref(x, be, up, gate, down, activation)

    def plain_paged(*args, max_length=None):
        return paged_decode_attention_ref(*args)

    def plain_quantized(*args, policy, max_length=None):
        return quantized_paged_decode_attention_ref(*args, policy=policy)

    with mock.patch.object(pda, "paged_decode_attention", plain_paged), \
            mock.patch.object(pda, "quantized_paged_decode_attention", plain_quantized), \
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
    rffn.ragged_ffn.launches = rffn.ragged_ffn.tc_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, stats = engine.run(requests)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {"paged_decode_attention": pda.paged_decode_attention.launches,
                "ragged_ffn": rffn.ragged_ffn.launches}
    if rffn.ragged_ffn.tc_launches != launches["ragged_ffn"]:
        raise AssertionError(f"ragged_ffn: {rffn.ragged_ffn.tc_launches} of "
                             f"{launches['ragged_ffn']} launches on the tensor-core route")

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
    return launches, e2e, out


def profile_steps(torch, cfg, params, serve, requests, n_steps=24):
    """torch.profiler over engine steps of the trace's first 8 requests,
    all admitted at once: device busy share (kernel time over wall time)
    and the kernels that take the device time."""
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
        open_session(torch)
        t0 = time.perf_counter()
        n = 0
        while n < n_steps and eng.scheduler.has_work():
            eng.step()
            n += 1
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device kernels (and copies) only: an aten op's own device time is that
    # of the kernels it launched, which are listed again as their own events.
    kernels = device_events(prof)

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
    """Record, per MoE layer, each row's top-1 expert, its router-logit
    margin over the runner-up (what a bf16 perturbation must overcome to
    flip the routing) and which of its choices fit their expert's capacity
    (``valid``, (rows, k))."""
    from unittest import mock

    from repro_torch.core import moe

    real = moe.route
    import torch

    def route(x, router_w, cfg, capacity, ctx=None):
        plan = real(x, router_w, cfg, capacity, ctx=ctx)
        with torch.no_grad():
            top2 = (x.float() @ router_w.float()).topk(2, dim=-1).values
            store.append((plan.expert_index[..., 0].reshape(-1).clone(),
                          (top2[..., 0] - top2[..., 1]).reshape(-1).clone(),
                          plan.valid.reshape(-1, plan.valid.shape[-1]).clone()))
        return plan

    with mock.patch.object(moe, "route", route):
        yield


def compare_mixed_step(torch, cfg, params, serve, requests, device="cuda"):
    """One mixed step's forward through the kernels, then (same pools,
    same rows) through the plain versions.  The two differ only in f32
    summation order before each bf16 rounding, but a bf16 difference can
    flip a top-1 routing decision whose router logits are nearly tied,
    and a flipped row (and the later rows of its slot, which attend to
    its K/V) then legitimately differs; over quantized pools so does every
    row of its slot from the start of its KV block on, since writing the
    row's K/V sets the whole block's scale and re-encodes the block's
    codes (``quant_write_kv``).  So: every routing flip is
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
    c = eng.cache
    pools = [t for t in (c.k_pool, c.v_pool, c.k_scales, c.v_scales) if t is not None]
    saved = [t.clone() for t in pools]
    route_k, route_p = [], []
    with recorded_routing(route_k):
        lk, _ = eng.forward_rows(sr.buffers)
    for t, t0 in zip(pools, saved):
        t.copy_(t0)
    with plain_versions(), recorded_routing(route_p):
        lp, _ = eng.forward_rows(sr.buffers)
    if device != "cpu":
        torch.cuda.synchronize()
    if not torch.isfinite(lk).all():
        raise AssertionError("kernel-path logits are not finite")

    b = sr.buffers
    live_rows = [r for r in range(sr.num_rows) if b["lengths"][r] > 0]
    block = c.block_size if c.k_scales is not None else 1   # the span a K/V write rescales
    affected = set()
    for layer, ((ek, mk, _), (ep, _, _)) in enumerate(zip(route_k, route_p)):
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
            start = b["positions"][r] - b["positions"][r] % block
            affected.update(q for q in live_rows if b["slots"][q] == b["slots"][r]
                            and b["positions"][q] >= start)
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
    agree = sum(int(ak[r] == ap[r]) for r in live_rows)
    log(f"  greedy argmax agrees on {agree}/{len(live_rows)} live rows")
    return dict(rows=len(live_rows), argmax_agree=agree, max_abs_logit_diff=diff,
                rows_after_routing_flip=len(affected))


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
    adamw_report = check_adamw(torch)
    counters = {"moe_ffn": mf.moe_ffn, "flash_attention": fa.flash_attention,
                "ragged_ffn": rffn.ragged_ffn, "paged_decode_attention": pda.paged_decode_attention}
    e2e, launches = {}, {}
    runs = (("top-1", [], 8), ("4 top-1", ["--routing", "prototype", "--k", "4"], 4))
    for label, extra, steps in runs:
        for fn in counters.values():
            fn.launches = 0
        mf.moe_ffn.tc_launches = 0
        torch.cuda.reset_peak_memory_stats()
        logs = train_run(torch, extra, steps)
        got = {name: fn.launches for name, fn in counters.items()}
        want = 5 * steps * 2        # layers x steps x (forward + remat recompute)
        if got["moe_ffn"] != want or any(got[n] for n in got if n != "moe_ffn"):
            raise AssertionError(f"{label}: launches {got}, expected moe_ffn = 5 layers x "
                                 f"{steps} steps x 2 = {want} and no other kernel")
        if mf.moe_ffn.tc_launches != want:
            raise AssertionError(f"{label}: {mf.moe_ffn.tc_launches} of {want} moe_ffn launches "
                                 f"on the tensor-core route")
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
            f"steps x 2 (forward + remat recompute), all on the tensor-core route; mean step "
            f"{step_ms:.1f} ms over steps 1-{steps - 1} (host clock, synced), "
            f"{e2e[label]['tokens_per_s']:.0f} tokens/s, first step "
            f"{e2e[label]['first_step_ms']:.0f} ms, peak memory "
            f"{e2e[label]['peak_memory_gb']:.1f} GB")
        log(f"    losses {[round(x, 4) for x in e2e[label]['losses']]}, dropped fraction "
            f"{[round(x, 4) for x in e2e[label]['dropped_fraction']]}")

    e2e["cuda_core_route"] = train_on_cuda_cores(torch, mf, runs)

    from repro_torch.launch.train import device_batch

    cfg, state, step_fn, pipeline = train_setup(TRAIN_ARGS + ["--steps", "8"])
    batch = device_batch(pipeline.batch_at(0), "cuda")
    e2e["top-1"].update(profile_train_steps(torch, state, step_fn, batch))
    e2e["kernels_vs_plain"] = compare_train_step(torch, cfg, state.params, batch)
    e2e["flash"] = compare_flash_forward(torch, cfg, state.params, batch, fa)
    del state, step_fn
    torch.cuda.empty_cache()
    e2e["dropless"] = dropless_gradient_step(torch, rffn, TRAIN_ARGS + DROPLESS_ARGS)
    e2e["adamw_on_card"] = adamw_report
    return launches, e2e


def check_adamw(torch):
    """The AdamW update of m6-shaped leaves (four f32 training leaves and a
    bf16 expert matrix) on the card at steps 1-4, and the trainer's 3-way
    microbatch average, bit-equal (int32 / int16 views) to the same on the
    CPU from the same inputs.  Beside them, the share of elements that a
    Python-number divisor moves on the card (PyTorch multiplies by its
    reciprocal there; the CPU divides): the fault the 0-dim device
    divisors of ``optim/adamw.py`` and ``train/trainer.py`` repair."""
    import numpy as np

    from repro_torch.optim.adamw import adamw
    from repro_torch.optim.schedules import warmup_constant
    from repro_torch.train.trainer import microbatch_mean

    def bits(t):
        return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)

    def same(a, b):
        return torch.equal(bits(a.cpu()), bits(b))

    leaves = {"blocks/attn/wq/kernel": ((5, 1024, 1024), torch.float32),
              "blocks/ffn/router": ((5, 1024, 32), torch.float32),
              "blocks/ln_attn/scale": ((5, 1024), torch.float32),
              "pos_embed": ((256, 1024), torch.float32),
              "blocks/ffn/up, one expert": ((1024, 4096), torch.bfloat16)}
    g = torch.Generator().manual_seed(600)
    opt = adamw(warmup_constant(1e-3, 2))
    cpu_p = {k: (torch.randn(s, generator=g) * 0.02).to(dt) for k, (s, dt) in leaves.items()}
    dev_p = {k: v.cuda() for k, v in cpu_p.items()}
    cpu_s, dev_s = opt.init(cpu_p), opt.init(dev_p)
    by_number = []
    for step in range(4):
        grads = {k: torch.randn(s, generator=g) * 1e-2 for k, (s, _) in leaves.items()}
        cpu_u, cpu_s = opt.update(grads, cpu_s, cpu_p, step)
        dev_u, dev_s = opt.update({k: v.cuda() for k, v in grads.items()}, dev_s, dev_p, step)
        torch.cuda.synchronize()
        for k in leaves:
            for what, a, b in (("update", dev_u[k], cpu_u[k]), ("mu", dev_s["mu"][k],
                               cpu_s["mu"][k]), ("nu", dev_s["nu"][k], cpu_s["nu"][k])):
                if not same(a, b):
                    raise AssertionError(f"AdamW step {step + 1} {k}: {what} on the card "
                                         f"differs from the CPU's")
        c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(step + 1))
        mu = cpu_s["mu"]["blocks/attn/wq/kernel"]
        moved = bits((mu.cuda() / c1).cpu()) != bits(mu / torch.full((), c1))
        by_number.append(float(moved.float().mean()))
        for k in leaves:
            for p, u in ((cpu_p[k], cpu_u[k]), (dev_p[k], dev_u[k])):
                p.copy_(p.float() + u.float())
    sums = {k: torch.randn(s, generator=g) * 3.0 for k, (s, _) in leaves.items()}
    cpu_mean = microbatch_mean(sums, 3)
    dev_mean = microbatch_mean({k: v.cuda() for k, v in sums.items()}, 3)
    torch.cuda.synchronize()
    if not all(same(dev_mean[k], cpu_mean[k]) for k in leaves):
        raise AssertionError("the 3-way microbatch average on the card differs from the CPU's")
    s = sums["blocks/attn/wq/kernel"]
    mean_moved = float((bits((s.cuda() / 3).cpu()) != bits(cpu_mean["blocks/attn/wq/kernel"])
                        ).float().mean())
    log(f"  AdamW on the card: updates, mu and nu of {len(leaves)} m6-shaped leaves bit-equal "
        f"to the CPU's at steps 1-4, and the 3-way microbatch average; with a Python-number "
        f"divisor (the repaired form) mu / c1 would differ in "
        f"{', '.join(f'{x:.4f}' for x in by_number)} of the elements at steps 1-4, and the "
        f"average in {mean_moved:.4f}")
    return dict(bit_equal_steps=4, python_number_divisor_moved=by_number,
                microbatch_mean_python_number_moved=mean_moved)


def train_on_cuda_cores(torch, mf, runs) -> dict:
    """The same training runs with the grouped FFN on its CUDA-core route
    (the device code before the tensor-core one), in the same call as the
    runs on the tensor cores: {label: mean step ms over steps 1 on}."""
    out = {}
    for label, extra, steps in runs:
        before = mf.moe_ffn.tc_launches
        logs = on_cuda_cores(mf, train_run)(torch, extra, steps)
        if mf.moe_ffn.tc_launches != before:
            raise AssertionError(f"{label}: the CUDA-core run launched the tensor cores")
        steady = logs[1:]
        out[label] = sum(m["step_time_s"] for m in steady) / len(steady) * 1e3
        log(f"  {label} with the grouped FFN on its CUDA-core route: mean step "
            f"{out[label]:.1f} ms over steps 1-{steps - 1} (host clock, synced)")
    return out


def profile_train_steps(torch, state, step_fn, batch, n_steps=2):
    """torch.profiler over ``n_steps`` train steps after one warm step:
    device busy share and the kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile

    state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_session(torch)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_events(prof)
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
    later tokens of its sequence).  Under an expert capacity a flip also
    moves the later tokens of the two experts' queues, so a token whose
    choice fits its expert's capacity in one forward and not in the other
    is reported too, and is affected like a flipped token; such a shift
    without any flip in its layer fails.  Returns (flips, affected token
    ids)."""
    flips, affected = [], set()
    for layer, ((ek, mk, vk), (ep, _, vp)) in enumerate(zip(routes_k[:layers],
                                                          routes_p[:layers])):
        reached = set(affected)
        flipped = torch_nonzero(ek != ep)
        for r in flipped:
            margin = float(mk[r])
            flips.append((layer, r, margin))
            log(f"  routing near-tie ({label}): layer {layer}, token {r}: expert {int(ek[r])} "
                f"(kernels) vs {int(ep[r])} (plain), router-logit margin {margin:.3g}")
            if r not in reached and margin > FLIP_MARGIN:
                raise AssertionError(f"{label}: routing flipped at margin {margin} > {FLIP_MARGIN}")
            affected.update(range(r, (r // seq_len + 1) * seq_len))
        shifted = [r for r in torch_nonzero((vk != vp).any(-1)) if r not in set(flipped)]
        if shifted and not flipped:
            raise AssertionError(f"{label}: layer {layer}: {len(shifted)} tokens kept or dropped "
                                 f"at capacity differently with no routing flip")
        for r in shifted:
            log(f"  capacity shift ({label}): layer {layer}, token {r}: expert {int(ek[r])} "
                f"{'keeps' if bool(vk[r].all()) else 'drops'} it (kernels), "
                f"{'keeps' if bool(vp[r].all()) else 'drops'} it (plain)")
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
    routing near-tie; the flash kernel launched once per layer, on the
    card every launch on its tensor-core route."""
    from repro_torch.models.transformer import lm_apply

    def run(use_flash, routes):
        with torch.no_grad(), recorded_routing(routes):
            return lm_apply(params, batch["tokens"], cfg, use_flash=use_flash,
                            extra_embeds=batch["patch_embeds"])[0]

    rf, rr = [], []
    fa.flash_attention.launches = fa.flash_attention.tc_launches = 0
    lf = run(True, rf)
    n, n_tc = fa.flash_attention.launches, fa.flash_attention.tc_launches
    lr = run(False, rr)
    if sync(torch, lf) and not n == n_tc == cfg.num_layers:
        raise AssertionError(f"flash_attention: {n} launches in one forward ({n_tc} on the "
                             f"tensor-core route), expected {cfg.num_layers} (one per layer, "
                             f"all on the tensor cores)")
    B, S = lf.shape[:2]
    flips, affected = _flip_report(rf, rr, cfg.num_layers, S, "flash forward")
    hit = torch.zeros(B * S, dtype=torch.bool, device=lf.device)
    hit[sorted(affected)] = True
    V = cfg.vocab_size
    a, b = lf.reshape(B * S, -1)[~hit, :V].float(), lr.reshape(B * S, -1)[~hit, :V].float()
    diff = float((a - b).abs().max())
    log(f"  lm_apply use_flash=True vs False: {n} flash launches (one per layer, {n_tc} on the "
        f"tensor cores); max abs "
        f"logit diff {diff:.4g} on {int((~hit).sum())} of {B * S} tokens (tolerance "
        f"{TOL} + {TOL} x |logit|, logit scale {float(b.abs().max()):.3g}); "
        f"{len(flips)} routing flips")
    if ((a - b).abs() > TOL + TOL * b.abs()).any():
        raise AssertionError(f"flash forward logits differ beyond tolerance: {diff}")
    return dict(max_abs_logit_diff=diff, launches=n, tc_launches=n_tc, routing_flips=len(flips))


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

    rffn.ragged_ffn.launches = rffn.ragged_ffn.tc_launches = 0
    gk = grads()
    n, n_tc = rffn.ragged_ffn.launches, rffn.ragged_ffn.tc_launches
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
    log(f"  dropless step: ragged_ffn launched {n} times (forward + remat recompute), "
        f"{n_tc} on the tensor-core route")
    return out


def token_match(base, other) -> float:
    """Position-wise greedy token agreement over the requests both served."""
    hit = tot = 0
    for uid in base.keys() & other.keys():
        a, b = base[uid], other[uid]
        tot += max(len(a), len(b))
        hit += sum(1 for x, y in zip(a, b) if x == y)
    return hit / max(tot, 1)


def serve_once(torch, cfg, params, serve, requests, device="cuda", **kw):
    """One engine's run of ``requests``: (tokens, stats, engine, wall ms)."""
    from repro_torch.serving.continuous import ContinuousEngine

    eng = ContinuousEngine(cfg, params, serve, device=device, **kw)
    table = params["embed"]["table"]
    sync(torch, table)
    t0 = time.perf_counter()
    out, stats = eng.run(requests)
    sync(torch, table)
    wall_ms = (time.perf_counter() - t0) * 1e3
    for r in requests:
        if len(out[r.uid]) != r.max_new_tokens:
            raise AssertionError(f"request {r.uid}: {len(out[r.uid])} tokens, budget "
                                 f"{r.max_new_tokens}")
    eng.cache.check_conservation()
    return out, stats, eng, wall_ms


def quant_serving_runs(torch, cfg, params, requests, base_tokens, device="cuda",
                       max_len=256, probe_lens=(24, 64)):
    """Phase 7 (a): the trace under kv_quant int8 then fp8.  Launch counts
    are reset once before the int8 run and read after the fp8 run; each run
    must launch the quantized attention kernel layers x steps times and the
    bf16 paged kernel never.  Returns (launches, report, {kv_quant: tokens})."""
    import dataclasses

    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.serving.trace import latency_line

    serve = ServeConfig(max_len=max(max_len, max(r.total_len for r in requests)))
    on_card = torch.device(device).type == "cuda"
    counters = {"quantized_paged_decode_attention": pda.quantized_paged_decode_attention,
                "paged_decode_attention": pda.paged_decode_attention,
                "ragged_ffn": rffn.ragged_ffn}
    for fn in counters.values():
        fn.launches = 0
    rffn.ragged_ffn.tc_launches = 0
    report, before, outs = {}, {n: 0 for n in counters}, {}
    for name in ("int8", "fp8"):
        out, stats, eng, wall_ms = serve_once(
            torch, cfg, params, dataclasses.replace(serve, kv_quant=name), requests, device)
        got = {n: fn.launches - before[n] for n, fn in counters.items()}
        before = {n: fn.launches for n, fn in counters.items()}
        steps = eng.steps
        want = cfg.num_layers * steps
        if on_card and (got["quantized_paged_decode_attention"] != want
                        or got["ragged_ffn"] != want or got["paged_decode_attention"]):
            raise AssertionError(f"kv_quant {name}: launches {got}, expected the quantized "
                                 f"kernel and ragged_ffn {want} = layers x steps, the bf16 "
                                 f"paged kernel 0")
        if stats["moe_dropped_fraction"] != 0.0:
            raise AssertionError(f"kv_quant {name}: dropped fraction "
                                 f"{stats['moe_dropped_fraction']}")
        match = token_match(base_tokens, out)
        outs[name] = out
        log(f"  kv_quant {name}: {latency_line(stats)}; {steps} steps, mean step "
            f"{wall_ms / steps:.3f} ms (host clock); launches {got}; token match against "
            f"phase 5 (bf16 pools) {match:.4f}; block bytes {eng.cache.block_bytes}")
        report[name] = dict(tokens_per_s=stats["generated_tokens_per_s"],
                            p50_ms=stats["p50_ms"], p95_ms=stats["p95_ms"],
                            mean_step_ms=wall_ms / steps, steps=steps,
                            token_match_vs_bf16=match, block_bytes=eng.cache.block_bytes)
    launches = {n: fn.launches for n, fn in counters.items()}
    if on_card and rffn.ragged_ffn.tc_launches != launches["ragged_ffn"]:
        raise AssertionError(f"kv_quant: {rffn.ragged_ffn.tc_launches} of "
                             f"{launches['ragged_ffn']} ragged_ffn launches on the tensor-core "
                             f"route")
    if on_card:
        log("  profile of int8 steps:")
        report["profile_int8"] = profile_steps(torch, cfg, params,
                                               dataclasses.replace(serve, kv_quant="int8"),
                                               requests)
    report["logit_divergence"] = logit_divergence(torch, cfg, params, serve, device,
                                                  probe_lens)
    report["kernels_vs_plain_int8"] = compare_mixed_step(
        torch, cfg, params, dataclasses.replace(serve, kv_quant="int8"), requests, device)
    return launches, report, outs


def logit_divergence(torch, cfg, params, serve, device="cuda", probe_lens=(24, 64)):
    """One request (24-token prompt, 64 generated on the card) replayed alone under
    none, int8 and fp8 through ``logit_tap``: the largest logit difference
    against ``none`` over the rows both runs computed (matched by slot and
    position), as benchmarks/serve_throughput.py measures it."""
    import dataclasses

    from repro_torch.serving.trace import synthetic_trace

    plen, glen = probe_lens
    probe = synthetic_trace(1, cfg.vocab_size, seed=3, qps=1e6, prompt_lens=(plen, plen),
                            gen_lens=(glen,))
    V = cfg.vocab_size
    rows, outs = {}, {}
    for name in ("none", "int8", "fp8"):
        got = rows[name] = {}

        def tap(lg, slots, pos, lens, got=got):
            for i, n in enumerate(lens):
                if n > 0:                       # length 0 = padding row
                    got[int(slots[i]), int(pos[i])] = lg[i, :V].copy()

        sv = dataclasses.replace(serve, max_slots=1, kv_quant=name,
                                 max_len=probe[0].total_len)
        outs[name] = serve_once(torch, cfg, params, sv, probe, device, logit_tap=tap)[0]
    res = {}
    for name in ("int8", "fp8"):
        common = rows["none"].keys() & rows[name].keys()
        div = max(float(abs(rows[name][k] - rows["none"][k]).max()) for k in common)
        res[name] = dict(max_logit_divergence=div, rows=len(common),
                         token_match=token_match(outs["none"], outs[name]))
        log(f"  logit divergence {name} vs none over {len(common)} rows of one replayed "
            f"request: {div:.4g} (token match {res[name]['token_match']:.4f})")
    return res


def capacity_runs(torch, cfg, params, device="cuda", blocks=(8, 15)):
    """Phase 7 (b): one device byte budget, 8 bf16 blocks, spent on bf16
    pools and on int8 pools (floor(8 * 327680 / 164480) = 15 blocks at
    m6-base), over a block-starved trace; peak running int8 / bf16 must
    reach 1.3, the reference benchmark's own assertion."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving.trace import synthetic_trace

    reqs = synthetic_trace(24, cfg.vocab_size, seed=0, qps=1e6, prompt_lens=(8, 16),
                           gen_lens=(16, 24))
    res, outs = {}, {}
    for name, n in zip(("none", "int8"), blocks):
        sv = ServeConfig(max_slots=8, kv_block_size=16, prefill_chunk=16, num_blocks=n,
                         kv_quant=name, max_len=max(r.total_len for r in reqs))
        outs[name], stats, eng, wall_ms = serve_once(torch, cfg, params, sv, reqs, device,
                                                     check_invariants=True)
        res[name] = dict(num_blocks=n, block_bytes=eng.cache.block_bytes,
                         pool_bytes=n * eng.cache.block_bytes,
                         peak_running=stats["peak_running"],
                         tokens_per_s=stats["generated_tokens_per_s"])
    res["peak_running_ratio"] = res["int8"]["peak_running"] / max(res["none"]["peak_running"], 1)
    res["token_match"] = token_match(outs["none"], outs["int8"])
    log(f"  capacity: bf16 {res['none']['num_blocks']} blocks x {res['none']['block_bytes']} B"
        f" = {res['none']['pool_bytes']} B, peak running {res['none']['peak_running']:.0f}; "
        f"int8 {res['int8']['num_blocks']} x {res['int8']['block_bytes']} B = "
        f"{res['int8']['pool_bytes']} B, peak running {res['int8']['peak_running']:.0f}; "
        f"ratio {res['peak_running_ratio']:.2f}; token match {res['token_match']:.4f}")
    if res["peak_running_ratio"] < 1.3:
        raise AssertionError(f"equal-byte int8 pools lift peak running only "
                             f"{res['peak_running_ratio']:.2f}x (< 1.3)")
    return res


def prefix_runs(torch, cfg, params, device="cuda", system_prompt_len=48, max_len=256):
    """Phase 7 (c): synthetic_multitenant(16, ...) (4 tenants, 48-token
    system prompts), prefix cache off and on, under none and int8."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving.trace import synthetic_multitenant

    reqs = synthetic_multitenant(16, cfg.vocab_size, seed=0, num_tenants=4,
                                 system_prompt_len=system_prompt_len)
    res = {}
    for name in ("none", "int8"):
        outs = {}
        for prefix in (False, True):
            sv = ServeConfig(max_len=max(max_len, max(r.total_len for r in reqs)),
                             kv_quant=name, prefix_cache=prefix)
            outs[prefix], stats, eng, wall_ms = serve_once(torch, cfg, params, sv, reqs,
                                                           device)
            key = f"{name} prefix {'on' if prefix else 'off'}"
            res[key] = dict(tokens_per_s=stats["generated_tokens_per_s"],
                            p50_ms=stats["p50_ms"], p95_ms=stats["p95_ms"],
                            steps=stats["steps"], mean_step_ms=wall_ms / eng.steps)
            if prefix:
                ratio = stats["cached_token_ratio"]
                res[key].update(cached_token_ratio=ratio, cached_tokens=stats["cached_tokens"],
                                **{k: eng.cache.stats[k] for k in
                                   ("bound_blocks", "published_blocks", "evicted_blocks")})
                if not ratio > 0:
                    raise AssertionError(f"{key}: cached-token ratio {ratio}")
            log(f"  multitenant {key}: {stats['generated_tokens_per_s']:.1f} tokens/s, "
                f"{stats['steps']:.0f} steps, mean step {wall_ms / eng.steps:.3f} ms, p50 "
                f"{stats['p50_ms']:.0f} ms, p95 {stats['p95_ms']:.0f} ms"
                + (f", cached-token ratio {stats['cached_token_ratio']:.3f}" if prefix else ""))
        res[f"{name} token_match_on_vs_off"] = token_match(outs[False], outs[True])
        log(f"  multitenant {name}: token match prefix on vs off "
            f"{res[f'{name} token_match_on_vs_off']:.4f}")
    return res


def dense_on_engine_pools(torch, cfg, params, requests, device="cuda", max_len=256,
                          gen=64):
    """Phase 7 (d): the dense-cache decode kernel (on no serving path of the
    reference) over the engine's own K/V.  Eight requests are served until
    they decode; the next step's decode rows are gathered from the bf16
    pools into dense (B, T, Hkv, D) caches, and in every layer
    ``decode_attention`` on them must agree with ``paged_decode_attention``
    on the pools for the same q.  Returns the dense kernel's launches."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.request import Request, Status

    serve = ServeConfig(max_len=max_len)
    eng = ContinuousEngine(cfg, params, serve, device=device)
    for r in requests[:8]:
        eng.scheduler.add(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=gen))
    while any(st.status is not Status.DECODE for st in eng.scheduler.running.values()) \
            or len(eng.scheduler.running) < 8:
        eng.step()
    b = eng.build_rows().buffers
    rows = [i for i in range(len(b["lengths"])) if b["lengths"][i] > 0]
    tbl = torch.from_numpy(b["row_tables"][rows]).to(device)
    lens = torch.from_numpy(b["lengths"][rows]).to(device)
    B, MB, bs = len(rows), tbl.shape[1], eng.cache.block_size
    g = torch.Generator(device=device).manual_seed(500)
    da.decode_attention.launches = 0
    err = 0.0
    for layer in range(cfg.num_layers):
        kp, vp = eng.cache.k_pool[layer], eng.cache.v_pool[layer]
        Hkv, D = kp.shape[1], kp.shape[3]
        q = torch.randn((B, cfg.num_heads, D), generator=g, device=device).to(kp.dtype)
        dense = [p[tbl.long()].permute(0, 1, 3, 2, 4).reshape(B, MB * bs, Hkv, D)
                 for p in (kp, vp)]
        got = da.decode_attention(q, *dense, lens)
        want = da.paged_decode_attention(q, kp, vp, tbl, lens)
        sync(torch, got)
        err = max(err, check_close(f"decode_attention vs paged, layer {layer} ({B} rows, "
                                   f"lengths {lens.min().item()}-{lens.max().item()})",
                                   got, want))
    return dict(launches=da.decode_attention.launches, max_abs_err_vs_paged=err)


def phase_kv(torch, base_tokens):
    """Phase 7: m6-base over the quantized and prefix-cached KV cache."""
    from repro_torch.configs.m6 import M6_BASE
    from repro_torch.nn import init_params
    from repro_torch.serving.trace import synthetic_trace

    log("phase 7: m6-base over int8/fp8 and prefix-cached paged KV pools")
    cfg = M6_BASE.replace_moe(impl="dropless", capacity_factor=None)
    params = init_params(cfg, seed=0, device="cuda")            # phase 5's weights
    requests = synthetic_trace(16, cfg.vocab_size, seed=0)
    launches, report, tokens = quant_serving_runs(torch, cfg, params, requests, base_tokens)
    report["capacity"] = capacity_runs(torch, cfg, params)
    report["prefix"] = prefix_runs(torch, cfg, params)
    report["dense_on_engine_pools"] = dense_on_engine_pools(torch, cfg, params, requests)
    launches["decode_attention"] = report["dense_on_engine_pools"]["launches"]
    return launches, report, tokens


# ---------------------------------------------------------------------------
# Phase 8: checkpoints and restarts
# ---------------------------------------------------------------------------

CKPT_LAYERS = 2                 # m6-base's widths at 2 layers: 567.4 M parameters


def bits(torch, t):
    """A tensor's bit patterns (an integer view), for bit-equality."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def map_tensors(torch, tree, fn):
    """``tree`` (NamedTuples, dicts) with each tensor replaced by ``fn(t)``
    and every other leaf kept: ``torch.zeros_like`` makes a restore
    template no saved value can hide in, a clone a snapshot."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(torch, v, fn) for v in tree))
    if isinstance(tree, dict):
        return {k: map_tensors(torch, v, fn) for k, v in tree.items()}
    return fn(tree.detach()) if isinstance(tree, torch.Tensor) else tree


def unequal_leaves(torch, a, b) -> list:
    """Keys of the leaves where two trees of one structure differ in any
    bit (tensors) or value (ints)."""
    from repro_torch.checkpoint import leaves

    return [k for (k, x), (_, y) in zip(leaves(a), leaves(b))
            if not (torch.equal(bits(torch, x), bits(torch, y))
                    if isinstance(x, torch.Tensor) else x == y)]


def max_param_diff(torch, a, b) -> float:
    """The largest |a - b| over two param trees' leaves (0.0: equal)."""
    from repro_torch.nn import flat_params

    fb = flat_params(b)
    with torch.no_grad():
        return max(float((t.float() - fb[k].float()).abs().max())
                   for k, t in flat_params(a).items())


def serving_tree(torch, cfg, trained):
    """The serving tree (``lm_shapes(cfg)``'s storage dtypes) of trained
    params, built in-process: each leaf cast as ``from_jax_params`` casts."""
    from repro_torch.configs.base import torch_dtype
    from repro_torch.nn import lm_shapes

    def cast(shapes, tree):
        if isinstance(shapes, dict):
            return {k: cast(v, tree[k]) for k, v in shapes.items()}
        return tree.detach().to(torch_dtype(shapes.dtype))

    return cast(lm_shapes(cfg), trained)


def tree_bytes(torch, tree) -> int:
    from repro_torch.checkpoint import leaves

    return sum(t.numel() * t.element_size() for _, t in leaves(tree)
               if isinstance(t, torch.Tensor))


def checkpoint_phase(torch, argv, device="cuda", layers=CKPT_LAYERS, requests=None,
                     max_len=256, root=None):
    """Phase 8, on a temporary directory under ``root`` (default the
    checkout's gitignored ``build/``) that is removed at its end.  The train
    CLI's loop (``repro_torch.launch.train.run``, the config cut to
    ``layers`` layers): 4 steps straight, twice (is the card's step
    bit-reproducible?); then 4 steps with ``--ckpt-every 2`` and a failure
    injected before step 3, so that ``run_with_restarts`` resumes from the
    checkpoint of step 2.  Gates: the step-2 checkpoint restores bit-equal
    to the state the loop held when it was taken; the resumed final params
    differ from a straight run's by no more than the two straight runs
    differ from each other; ``requests`` (default the 16-request trace)
    served from ``restore_params_latest`` give the greedy tokens of an
    engine built in-process from the trained params; the serving tree's
    bf16 params-only checkpoint round-trips bit-equal.  Measures a
    synchronous ``save`` of the final training state (seconds, GB/s) and
    ``save_async``'s snapshot.  Fails before writing if the disk lacks the
    bytes."""
    import shutil
    import tempfile
    from unittest import mock

    from repro_torch.checkpoint import Checkpointer, leaves
    from repro_torch.configs.base import ServeConfig
    from repro_torch.launch import train as train_mod
    from repro_torch.nn import count_params, init_params
    from repro_torch.serving.trace import synthetic_trace

    build_full = train_mod.build

    def build_cut(args):
        return build_full(args).replace(num_layers=layers)

    parse = train_mod.build_parser().parse_args
    base = argv + ["--steps", "4", "--device", device]
    cfg = build_cut(parse(base))
    n_params = count_params(cfg)
    ckpt_bytes = 12 * n_params + 4                 # f32 masters, mu and nu; the step
    root = Path(root or ROOT / "build")
    root.mkdir(parents=True, exist_ok=True)
    need = 2 * ckpt_bytes + 4 * n_params + (1 << 30)   # two kept, the serving tree, slack
    free = shutil.disk_usage(root).free
    if free < need:
        raise AssertionError(f"phase 8 needs {need} bytes free under {root}; {free} are")
    log(f"  m6-base widths at {layers} layers: {n_params} parameters, a training checkpoint "
        f"{ckpt_bytes / 1e9:.2f} GB; {free / 1e9:.1f} GB free under {root}")
    tmp = Path(tempfile.mkdtemp(prefix="ckpt-", dir=root))
    out = {"layers": layers, "parameters": n_params, "checkpoint_bytes": ckpt_bytes}
    try:
        with mock.patch.object(train_mod, "build", build_cut):
            straight = []
            for i in range(2):
                t0 = time.perf_counter()
                _, st = train_mod.run(parse(base))
                sync(torch, st.params["embed"]["table"])
                straight.append(st.params)
                log(f"  straight run {i + 1}: 4 steps, {time.perf_counter() - t0:.1f} s")
                del st
            d_straight = max_param_diff(torch, straight[0], straight[1])
            del straight[1]
            log(f"  two straight runs: largest parameter difference {d_straight:g} "
                f"({'bit-reproducible' if d_straight == 0 else 'not bit-reproducible'})")

            snapshot, failed = {}, []

            def probe(step, state):
                if step == 2 and not snapshot:      # what the step-2 checkpoint holds
                    snapshot["state"] = map_tensors(torch, state, torch.clone)
                if step == 3 and not failed:
                    failed.append(step)
                    raise RuntimeError("injected failure before step 3")

            ckpt_dir = tmp / "train"
            t0 = time.perf_counter()
            logs, resumed = train_mod.run(
                parse(base + ["--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2",
                              "--max-restarts", "1"]), on_step=probe)
            sync(torch, resumed.params["embed"]["table"])
            run_s = time.perf_counter() - t0
        steps = [m["step"] for m in logs]
        if failed != [3] or steps != [0, 1, 2, 2, 3] or resumed.step != 4:
            raise AssertionError(f"restart: failures {failed}, logged steps {steps}, final "
                                 f"step {resumed.step}; want [3], [0, 1, 2, 2, 3], 4")
        ck = Checkpointer(str(ckpt_dir))
        if ck.all_steps() != [2, 4]:
            raise AssertionError(f"checkpoints {ck.all_steps()}, want [2, 4]")
        back = ck.restore(2, map_tensors(torch, resumed, torch.zeros_like))
        diff = unequal_leaves(torch, snapshot["state"], back)
        if diff:
            raise AssertionError(f"step-2 checkpoint: leaves not bit-equal to the state it "
                                 f"was taken from: {diff[:5]}")
        del back, snapshot
        d_resume = max_param_diff(torch, straight[0], resumed.params)
        log(f"  resumed run ({run_s:.1f} s; a failure before step 3, restarted from the "
            f"step-2 checkpoint, which restores bit-equal): largest parameter difference "
            f"from a straight run {d_resume:g} (two straight runs: {d_straight:g})")
        if d_resume > d_straight:
            raise AssertionError(f"resumed params differ by {d_resume:g} from a straight run's, "
                                 f"more than two straight runs differ ({d_straight:g})")
        out.update(straight_runs_max_diff=d_straight, resumed_max_diff=d_resume)

        # a training checkpoint's save times (the final state: masters, mu, nu, step)
        nbytes = tree_bytes(torch, resumed) + 4
        ck_t = Checkpointer(str(tmp / "timing"), keep=1)
        t0 = time.perf_counter()
        ck_t.save_async(1, resumed)
        snapshot_s = time.perf_counter() - t0
        ck_t.wait()
        async_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck_t.save(2, resumed)
        save_s = time.perf_counter() - t0
        shutil.rmtree(tmp / "timing")
        log(f"  save of a training checkpoint ({nbytes / 1e9:.2f} GB): {save_s:.2f} s, "
            f"{nbytes / save_s / 1e9:.2f} GB/s; save_async's snapshot (device to host) "
            f"{snapshot_s:.2f} s, its files written {async_s:.2f} s after the call")
        out.update(save_s=save_s, save_gb_per_s=nbytes / save_s / 1e9,
                   save_async_snapshot_s=snapshot_s, save_async_written_s=async_s)

        # serving: from the checkpoint, and from the trained params in-process
        scfg = cfg.replace_moe(impl="dropless", capacity_factor=None)
        requests = requests or synthetic_trace(16, scfg.vocab_size, seed=0)
        serve = ServeConfig(max_len=max(max_len, max(r.total_len for r in requests)))
        params, step = ck.restore_params_latest(init_params(scfg, seed=1, device=device))
        got, _, _, _ = serve_once(torch, scfg, params, serve, requests, device=device)
        want, _, _, _ = serve_once(torch, scfg, serving_tree(torch, scfg, resumed.params),
                                   serve, requests, device=device)
        del resumed, straight
        same = sum(got[r.uid] == want[r.uid] for r in requests)
        if step != 4 or same != len(requests):
            raise AssertionError(f"served from checkpoint step {step}: {same} of "
                                 f"{len(requests)} requests' greedy tokens equal the "
                                 f"in-process engine's")
        log(f"  restored params-only from checkpoint step {step}: the {len(requests)} requests' "
            f"greedy tokens equal those of an engine built from the trained params")
        shutil.rmtree(ckpt_dir)

        # the serving tree (bf16 matmul weights) as a params-only checkpoint
        ck_s = Checkpointer(str(tmp / "serve"))
        ck_s.save(1, params)
        back = ck_s.restore(1, map_tensors(torch, params, torch.zeros_like))
        n_bf16 = sum(t.dtype == torch.bfloat16 for _, t in leaves(params))
        diff = unequal_leaves(torch, params, back)
        if diff or (scfg.dtype == "bfloat16" and n_bf16 == 0):
            raise AssertionError(f"serving tree round trip: {n_bf16} bf16 leaves; not "
                                 f"bit-equal: {diff[:5]}")
        log(f"  the serving tree ({n_bf16} bf16 of {len(leaves(params))} leaves, "
            f"{tree_bytes(torch, params) / 1e9:.2f} GB) round-trips bit-equal")
        out.update(served_requests=len(requests), serving_tree_bf16_leaves=n_bf16)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# Phase 9: speculative and sampled serving
# ---------------------------------------------------------------------------

SPEC_GAMMA = 4
SAMPLE_T = 0.8
SAMPLE_T_LOW = 0.05             # peaked enough that the model drafter's drafts are accepted
RANDOM_DRAFTER = "chip-smoke-random"


class RandomDrafter:
    """Proposes ``max_tokens`` seeded random ids every round, so nearly every
    draft is rejected and rolled back."""

    name = RANDOM_DRAFTER

    def __init__(self, spec, target_cfg, serve, *, seed=0, draft_model=None, device="cuda"):
        import numpy as np

        self.rng = np.random.default_rng(seed + 0xD4AF7)
        self.vocab = target_cfg.vocab_size

    def propose(self, items):
        return [self.rng.integers(0, self.vocab, it.max_tokens).astype("int32") for it in items]


def logit_tie(margin: float, top: float) -> bool:
    """A top-two gap that two logits, each moved by the kernels-vs-plain
    tolerance (TOL + TOL x |logit|), can close."""
    return margin <= 2 * (TOL + TOL * abs(top))


def tapped_margins(torch, cfg, params, serve, requests, device="cuda"):
    """A non-speculative run with ``logit_tap``: ({uid: tokens}, {(uid,
    position): (top-two logit gap, top logit)}) over every live row."""
    import numpy as np

    V = cfg.vocab_size
    margins, holder = {}, []

    def tap(lg, slots, pos, lens):
        running = holder[0].scheduler.running
        for i in np.flatnonzero(lens > 0):
            top2 = np.partition(lg[i, :V], V - 2)[V - 2:]
            margins[running[int(slots[i])].request.uid, int(pos[i])] = (
                float(top2[1] - top2[0]), float(top2[1]))

    from repro_torch.serving.continuous import ContinuousEngine

    eng = ContinuousEngine(cfg, params, serve, device=device, logit_tap=tap)
    holder.append(eng)
    out, _ = eng.run(requests)
    return out, margins


def first_divergences(base, other, margins, requests, label):
    """Requests whose tokens differ from ``base``: each must first differ
    where the non-speculative run's top-two logits are a near-tie
    (``logit_tie``); reported with the gap.  Returns [(uid, index, gap)]."""
    plen = {r.uid: r.prompt_len for r in requests}
    out = []
    for uid in sorted(base):
        a, b = base[uid], other[uid]
        if a == b:
            continue
        p = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        gap, top = margins[uid, plen[uid] - 1 + p]
        out.append((uid, p, gap))
        log(f"  {label}: request {uid} first differs at generated token {p} ({a[p]} "
            f"non-speculative, {b[p]} here): non-speculative top-two logit gap {gap:.4g} "
            f"(top logit {top:.4g})")
        if not logit_tie(gap, top):
            raise AssertionError(f"{label}: request {uid} differs at token {p} where the top "
                                 f"two logits are {gap} apart, not a near-tie")
    return out


@contextmanager
def recorded_acceptance(store: list):
    """Record every slot's (drafts, accepted drafts, emitted) of every
    verify step."""
    from unittest import mock

    from repro_torch.serving import continuous

    real_g, real_r = continuous.accept_greedy_ids, continuous.accept_rejection

    def greedy(d, rows):
        emitted, n = real_g(d, rows)
        store.append((len(d), n, len(emitted)))
        return emitted, n

    def rejection(d, rows, t, rng):
        emitted, n = real_r(d, rows, t, rng)
        store.append((len(d), n, len(emitted)))
        return emitted, n

    with mock.patch.object(continuous, "accept_greedy_ids", greedy), \
            mock.patch.object(continuous, "accept_rejection", rejection):
        yield


@contextmanager
def recorded_ffn_shapes(store: dict):
    """Count the dropless dispatcher's ragged FFN calls by (rows, block
    rows).  The dispatcher's handle on the kernel module is swapped, not the
    module's own ``ragged_ffn``, whose launch counters stay in place."""
    from types import SimpleNamespace
    from unittest import mock

    from repro_torch.core.dispatch import dropless

    real = dropless.dropless_ops.ragged_ffn

    def ffn(x, be, *args, block_x=128, **kw):
        key = (int(x.shape[0]), int(block_x))
        store[key] = store.get(key, 0) + 1
        return real(x, be, *args, block_x=block_x, **kw)

    with mock.patch.object(dropless, "dropless_ops", SimpleNamespace(ragged_ffn=ffn)):
        yield


def spec_run(torch, cfg, params, serve, requests, device, **kw):
    """One speculative run with the kernels' launch counters reset just
    before it and read just after: (tokens, stats, engine, wall ms,
    launches, per-slot acceptances, ragged FFN shapes)."""
    from repro_torch.kernels.decode_attention import ops as pda
    from repro_torch.kernels.moe_dropless import ops as rffn

    counters = {"paged_decode_attention": pda.paged_decode_attention,
                "quantized_paged_decode_attention": pda.quantized_paged_decode_attention,
                "ragged_ffn": rffn.ragged_ffn}
    for fn in counters.values():
        fn.launches = 0
    rffn.ragged_ffn.tc_launches = 0
    accepts, shapes = [], {}
    with recorded_acceptance(accepts), recorded_ffn_shapes(shapes):
        out, stats, eng, wall_ms = serve_once(torch, cfg, params, serve, requests, device,
                                              check_invariants=True, **kw)
    launches = {n: fn.launches for n, fn in counters.items()}
    launches["ragged_ffn tensor cores"] = rffn.ragged_ffn.tc_launches
    return out, stats, eng, wall_ms, launches, accepts, shapes


def spec_report(stats, eng, wall_ms, accepts) -> dict:
    return dict(tokens_per_s=stats["generated_tokens_per_s"], p50_ms=stats["p50_ms"],
                p95_ms=stats["p95_ms"], steps=eng.steps, mean_step_ms=wall_ms / eng.steps,
                verify_steps=eng.spec_stats["verify_steps"],
                spec_acceptance_rate=stats.get("acceptance_rate"),
                spec_tokens_per_step=stats.get("spec_tokens_per_step"),
                max_accepted_in_a_step=max((n for _, n, _ in accepts), default=0),
                partial_acceptances=sum(0 < n < d for d, n, _ in accepts))


def spec_serving_runs(torch, cfg, params, requests, base_tokens, int8_tokens, device="cuda",
                      max_len=256, gamma=SPEC_GAMMA):
    """Phase 9 (a) and (b): greedy speculative decoding with the ngram, model
    (the target's own weights) and random drafters over bf16 pools, then
    ngram over int8 pools; each held to the non-speculative tokens."""
    import dataclasses

    from repro_torch.configs.base import ServeConfig, SpecConfig
    from repro_torch.serving.speculative import available_drafters, register_drafter
    from repro_torch.serving.trace import latency_line

    if RANDOM_DRAFTER not in available_drafters():
        register_drafter(RandomDrafter)
    on_card = torch.device(device).type == "cuda"
    serve = ServeConfig(max_len=max(max_len, max(r.total_len for r in requests)))
    ref, margins = {}, {}
    for kv, base in (("none", base_tokens), ("int8", int8_tokens)):
        ref[kv], margins[kv] = tapped_margins(torch, cfg, params,
                                              dataclasses.replace(serve, kv_quant=kv),
                                              requests, device)
        if ref[kv] != base:
            raise AssertionError(f"kv_quant {kv}: a second non-speculative run gave other "
                                 f"tokens than the first")
    report = {}
    for drafter, kv in (("ngram", "none"), ("model", "none"), (RANDOM_DRAFTER, "none"),
                        ("ngram", "int8")):
        label = f"{drafter} over {'bf16' if kv == 'none' else kv} pools"
        sv = dataclasses.replace(serve, kv_quant=kv,
                                 spec=SpecConfig(drafter=drafter, gamma=gamma))
        dm = (cfg, params) if drafter == "model" else None
        out, stats, eng, wall_ms, launches, accepts, shapes = spec_run(
            torch, cfg, params, sv, requests, device, draft_model=dm)
        want = cfg.num_layers * eng.steps
        attn = "paged_decode_attention" if kv == "none" else "quantized_paged_decode_attention"
        other = "quantized_paged_decode_attention" if kv == "none" else "paged_decode_attention"
        if on_card and (launches[attn] != want or launches[other]):
            raise AssertionError(f"{label}: launches {launches}, expected {attn} {want} = "
                                 f"layers x steps and {other} 0")
        if on_card and launches["ragged_ffn tensor cores"] != launches["ragged_ffn"]:
            raise AssertionError(f"{label}: {launches['ragged_ffn tensor cores']} of "
                                 f"{launches['ragged_ffn']} ragged_ffn launches on the "
                                 f"tensor-core route")
        if stats["moe_dropped_fraction"] != 0.0:
            raise AssertionError(f"{label}: dropped fraction {stats['moe_dropped_fraction']}")
        rep = spec_report(stats, eng, wall_ms, accepts)
        if rep["verify_steps"] <= 0:
            raise AssertionError(f"{label}: no verify step ran")
        if drafter == "model" and rep["max_accepted_in_a_step"] < 2:
            raise AssertionError(f"{label}: no verify step accepted 2 or more drafts")
        rep["divergences"] = first_divergences(ref[kv], out, margins[kv], requests, label)
        rep["token_match"] = token_match(ref[kv], out)
        rep["launches"] = launches
        rep["ragged_ffn_shapes"] = {f"{n} rows, bx {bx}": c for (n, bx), c in shapes.items()}
        log(f"  {label}: {latency_line(stats)}; {eng.steps} steps ({rep['verify_steps']} "
            f"verify), mean step {rep['mean_step_ms']:.3f} ms (host clock); acceptance "
            f"{rep['spec_acceptance_rate']:.3f}, {rep['spec_tokens_per_step']:.3f} tokens a "
            f"verify step, at most {rep['max_accepted_in_a_step']} drafts accepted in one "
            f"step; token match {rep['token_match']:.4f}; launches {launches}; ragged FFN "
            f"calls by shape {rep['ragged_ffn_shapes']}")
        report[label] = rep
    return report


def sampler_checks(torch, device="cuda", T=SAMPLE_T, seed=5):
    """Phase 9 (c), the sampler alone: over fixed f32 logits, the tokens
    ``_sample_rows`` draws on ``device`` for 4096 (slot, position) keys
    against the CPU's (the integer uniforms must be equal; a token may
    differ only at a near-tie of the perturbed scores), and a 20 000-key
    frequency test against softmax(logits / T) at atol 0.015, the
    reference's own bound."""
    import numpy as np

    from repro_torch.serving.continuous import _row_uniforms, _sample_rows

    rng = np.random.default_rng(21)
    logits = (rng.standard_normal((4096, 1024)) * 2.0).astype(np.float32)
    slots = rng.integers(0, 8, 4096)
    pos = rng.permutation(4096)
    lg_dev = torch.from_numpy(logits).to(device)
    u_dev = _row_uniforms(seed, slots, pos, 1024, torch.device(device)).cpu()
    u_cpu = _row_uniforms(seed, slots, pos, 1024, torch.device("cpu"))
    if not torch.equal(u_dev, u_cpu):
        raise AssertionError("the sampler's uniforms differ between the card and the CPU")
    got = _sample_rows(lg_dev, slots, pos, T, seed).cpu()
    want = _sample_rows(torch.from_numpy(logits), slots, pos, T, seed)
    t = torch.tensor(T, dtype=torch.float32)
    scores = (torch.from_numpy(logits) / t).double() - torch.log(-torch.log(u_cpu))
    ties = 0
    for r in torch.nonzero(got != want).flatten().tolist():
        a, b = float(scores[r, got[r]]), float(scores[r, want[r]])
        if abs(a - b) > 1e-9 * max(1.0, abs(b)):
            raise AssertionError(f"sampled token differs from the CPU's at key {r}: scores "
                                 f"{a} and {b} are no near-tie")
        ties += 1
    V = 6
    probe = (rng.standard_normal((1, V)) * 2.0).astype(np.float32)
    n = 20_000
    keys = np.arange(n)
    draws = _sample_rows(torch.from_numpy(np.repeat(probe, n, 0)).to(device), keys % 8,
                         keys // 8, T, seed).cpu().numpy()
    z = probe[0].astype(np.float64) / T
    p = np.exp(z - z.max())
    p /= p.sum()
    freq = np.bincount(draws, minlength=V) / n
    err = float(np.abs(freq - p).max())
    log(f"  sampler: 4096 keys over 1024 logits, the card's tokens equal the CPU's on "
        f"{4096 - ties} ({ties} near-tie differences); frequencies of {n} draws within "
        f"{err:.4f} of softmax(logits / {T}) (bound 0.015)")
    if err > 0.015:
        raise AssertionError(f"sampled frequencies {err} off softmax(logits / T) (> 0.015)")
    return dict(keys=4096, near_tie_differences=ties, frequency_max_err=err)


def sampled_serving_runs(torch, cfg, params, requests, device="cuda", max_len=256,
                         T=SAMPLE_T, T_low=SAMPLE_T_LOW, seed=7, gamma=SPEC_GAMMA):
    """Phase 9 (c), served: the trace greedy (the step-time baseline), at
    temperature T without speculation, with ngram and with the model
    drafter (which always drafts, so its verify steps run the host's
    rejection sampling), and at the low temperature ``T_low`` with the
    model drafter, where drafts must be accepted (multi-token emissions of
    ``accept_rejection``, rollback after a partial acceptance); each run
    twice with one seed, the two runs must give the same tokens, every id
    in the vocab.  Every request arrives at t = 0: admission then does not
    hang on the host's clock, so each request gets the same slot in both
    runs, and with it the same sampling keys (seed, slot, position)."""
    import dataclasses

    from repro_torch.configs.base import ServeConfig, SpecConfig
    from repro_torch.serving.trace import latency_line

    requests = [dataclasses.replace(r, arrival_ms=0.0) for r in requests]
    serve = ServeConfig(max_len=max(max_len, max(r.total_len for r in requests)))
    report = {}
    for t, drafter in ((0.0, None), (T, None), (T, "ngram"), (T, "model"), (T_low, "model")):
        label = (f"T = {t}, " if t else "greedy, ") + (drafter or "no speculation")
        sv = serve if drafter is None else dataclasses.replace(
            serve, spec=SpecConfig(drafter=drafter, gamma=gamma))
        dm = (cfg, params) if drafter == "model" else None
        runs = [spec_run(torch, cfg, params, sv, requests, device, temperature=t, seed=seed,
                         draft_model=dm) for _ in range(2)]
        (out, stats, eng, wall_ms, _, accepts, _), (again, *_) = runs
        if out != again:
            raise AssertionError(f"{label}: two runs with one seed gave other tokens")
        bad = [tok for v in out.values() for tok in v if not 0 <= tok < cfg.vocab_size]
        if bad:
            raise AssertionError(f"{label}: sampled ids outside the vocab: {bad[:8]}")
        if drafter == "model" and eng.spec_stats["verify_steps"] <= 0:
            raise AssertionError(f"{label}: no verify step ran")
        rep = spec_report(stats, eng, wall_ms, accepts) if drafter else dict(
            tokens_per_s=stats["generated_tokens_per_s"], p50_ms=stats["p50_ms"],
            p95_ms=stats["p95_ms"], steps=eng.steps, mean_step_ms=wall_ms / eng.steps)
        if t == T_low and (eng.spec_stats["accepted"] <= 0
                           or not any(e >= 2 for _, _, e in accepts)):
            raise AssertionError(f"{label}: no draft accepted, or no verify step emitted 2 or "
                                 f"more tokens ({eng.spec_stats})")
        log(f"  {label}: {latency_line(stats)}; {eng.steps} steps, mean step "
            f"{rep['mean_step_ms']:.3f} ms (host clock)"
            + (f"; {rep['verify_steps']} verify steps, acceptance "
               f"{rep['spec_acceptance_rate']:.3f}, {rep['spec_tokens_per_step']:.3f} tokens "
               f"a verify step, {rep['partial_acceptances']} partial acceptances"
               if drafter else "")
            + "; the second run's tokens equal the first's")
        report[label] = rep
    return report


def verify_attention_case(slot_lens, drafts, seed, name=None):
    """The verify step's attention at m6 widths: 8 slots of context c, each
    with its g + 1 rows of lengths c + 1 .. c + g + 1 sharing the slot's
    block table, the other rows of its gamma + 1 length 0; bf16 pools, or
    their int8 codes and scales (``name``).  (q, pools..., tables, lengths)
    in the wrapper's order."""
    import torch

    W = SPEC_GAMMA + 1
    q8, kp, vp, tables, _ = attention_case(len(slot_lens), 16, 16, 64, 16, 16,
                                           [c + g + 1 for c, g in zip(slot_lens, drafts)],
                                           seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn((len(slot_lens) * W, 16, 64), generator=g, device="cuda").to(q8.dtype)
    lens = [c + j + 1 if j <= d else 0 for c, d in zip(slot_lens, drafts) for j in range(W)]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    tables = tables.repeat_interleave(W, 0).contiguous()
    if name is None:
        return q, kp, vp, tables, lengths
    kc, ks, vc, vs = quantize_pools(kp, vp, name)
    return q, kc, vc, ks, vs, tables, lengths


def verify_attention_bound(q, pool, lengths, quantized):
    """q read and out written once; each slot's K/V positions once (its
    rows share them), with one K and one V scale per (block, head) when
    quantized; the tables and lengths.  Flops over every row's length."""
    N, Hq, D = q.shape
    Hkv, bs = pool.shape[1], pool.shape[2]
    W = SPEC_GAMMA + 1
    per_slot = lengths.reshape(-1, W).amax(dim=1).float()
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * float(per_slot.sum()) * Hkv * D * pool.element_size()
              + N * 16 * 4 + N * 4)
    if quantized:
        nbytes += 2 * float(((per_slot + bs - 1) // bs).sum()) * Hkv * 4
    return roofline(nbytes, 4.0 * Hq * D * float(lengths.sum()))


def time_verify_attention(torch, name=None, seed=130):
    """Kernel, plain and library times of the paged (bf16) or quantized
    (int8) kernel at the verify step's shape, 40 rows over 16 rotating
    copies, after holding the kernel against its plain version (length-0
    rows exactly 0)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.decode_attention.ref import (
        paged_decode_attention_ref,
        quantized_paged_decode_attention_ref,
    )
    from repro_torch.quant import get_kv_quant

    slot_lens, drafts = [21, 56, 112, 9, 74, 33, 98, 47], [4, 4, 2, 0, 4, 1, 4, 3]
    copies = [verify_attention_case(slot_lens, drafts, seed + c, name) for c in range(16)]
    longest = max(c + d + 1 for c, d in zip(slot_lens, drafts))
    if name is None:
        def call(c):
            return da.paged_decode_attention(*c, max_length=longest)

        def plain(c):
            return paged_decode_attention_ref(*c)
    else:
        pol = get_kv_quant(name)

        def call(c):
            return da.quantized_paged_decode_attention(*c, policy=pol, max_length=longest)

        def plain(c):
            return quantized_paged_decode_attention_ref(*c, policy=pol)

    c0 = copies[0]
    q, pool, tables, lengths = c0[0], c0[1], c0[-2], c0[-1]
    got = call(c0)
    err = check_close(f"verify shape, {'bf16' if name is None else name} pools", got, plain(c0))
    if (got[lengths == 0] != 0).any():
        raise AssertionError("verify shape: a length-0 row's output is not exactly 0")
    bound, by = verify_attention_bound(q, pool, lengths, name is not None)
    it = iter(range(1 << 30))
    k_ms = cuda_ms(lambda: call(copies[next(it) % 16]))
    k_dev = device_ms(lambda: call(copies[next(it) % 16]), bound_ms=bound)
    p_ms = cuda_ms(lambda: plain(copies[next(it) % 16]))
    N, Hq, D = q.shape
    Hkv, bs, MB = pool.shape[1], pool.shape[2], tables.shape[1]
    tbl = tables.long()
    if name is None:
        kk, vv = c0[1][tbl], c0[2][tbl]
    else:
        kk = (pol.decode(c0[1][tbl]) * c0[3][tbl][..., None, None]).to(q.dtype)
        vv = (pol.decode(c0[2][tbl]) * c0[4][tbl][..., None, None]).to(q.dtype)
    kk = kk.permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    vv = vv.permute(0, 2, 1, 3, 4).reshape(N, Hkv, MB * bs, D)
    mask = (torch.arange(MB * bs, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None, :], kk, vv, attn_mask=mask)

    return dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, library_ms=cuda_ms(sdpa),
                library_device_ms=device_ms(sdpa, bound_ms=bound), bound_ms=bound, bound_by=by,
                max_abs_err=err, plan=da.launch_plan(q, pool, tables, max_length=longest))


def phase_spec(torch, base_tokens, int8_tokens, e2e, kv):
    """Phase 9: m6-base speculative and sampled serving, phase 5's weights
    and trace."""
    from repro_torch.configs.m6 import M6_BASE
    from repro_torch.nn import init_params
    from repro_torch.serving.trace import synthetic_trace

    log("phase 9: m6-base speculative and sampled serving")
    cfg = M6_BASE.replace_moe(impl="dropless", capacity_factor=None)
    params = init_params(cfg, seed=0, device="cuda")            # phase 5's weights
    requests = synthetic_trace(16, cfg.vocab_size, seed=0)
    report = {"greedy": spec_serving_runs(torch, cfg, params, requests, base_tokens,
                                          int8_tokens)}
    report["sampler"] = sampler_checks(torch)
    report["sampled"] = sampled_serving_runs(torch, cfg, params, requests)
    log(f"  phase 5 (no speculation, bf16 pools): {e2e['tokens_per_s']:.1f} tokens/s, mean "
        f"step {e2e['mean_step_ms']:.3f} ms, p50 {e2e['p50_ms']:.0f} ms, p95 "
        f"{e2e['p95_ms']:.0f} ms, {e2e['steps']} steps; phase 7 int8 "
        f"{kv['int8']['tokens_per_s']:.1f} tokens/s, mean step "
        f"{kv['int8']['mean_step_ms']:.3f} ms")
    timing = {"paged_decode_attention": time_verify_attention(torch),
              "quantized_paged_decode_attention": time_verify_attention(torch, "int8"),
              "ragged_ffn": time_ffn(torch, 8 * (SPEC_GAMMA + 1), seed=140, weights=None)}
    timing["ragged_ffn model drafter"] = time_ffn(torch, 1024, seed=150, weights=None,
                                                  groups=2)
    for name, r in timing.items():
        log(f"  verify shape {name}: {timing_line(r)}")
    report["timing"] = timing
    return report


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
        tc = ptxas_functions(rep, TC_KERNELS.get(name, "-"))
        if tc:
            log(f"    tensor-core kernels: {len(tc)}, registers "
                f"{min(r for r, _ in tc.values())}-{max(r for r, _ in tc.values())}, spill "
                f"stores up to {max(sp for _, sp in tc.values())} bytes")
            spilled = [f for f, (_, sp) in tc.items() if sp]
            if spilled:
                raise AssertionError(f"{name}: tensor-core kernels spill: {spilled}")
        if name == "flash_attention":
            for fn, (regs, sp) in sorted(tc.items()):
                log(f"      {fn}: {regs} registers, {sp} bytes spill stores")
        if name in DECODE_LIBS:
            fns = ptxas_functions(rep, DECODE_KERNEL)
            if not fns:
                raise AssertionError(f"{name}: no {DECODE_KERNEL} in its ptxas report")
            spilled = [f for f, (_, sp) in fns.items() if sp]
            if spilled:
                raise AssertionError(f"{name}: decode kernels spill: {spilled}")
            log(f"    decode kernels: {len(fns)}, registers {min(r for r, _ in fns.values())}-"
                f"{max(r for r, _ in fns.values())}, no spill stores")
        for line in rep.splitlines():
            if "wgmma" in line.lower() and "warning" in line.lower():
                log(f"    ptxas: {line.strip()[:200]}")
    check_sass(build)

    errs, ffn_weights = phase_check(torch)
    timing, timing_mixed = phase_timing(torch, ffn_weights)
    timing.update(phase_timing_training(torch))
    again = remeasure(torch, timing, ffn_weights)
    del ffn_weights
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, e2e, base_tokens = phase_serve(torch)
    serve_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_launches, train = phase_train(torch)
    train_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kv_launches, kv, kv_tokens = phase_kv(torch, base_tokens)
    kv_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log("phase 8: checkpoints and restarts, m6-base widths at 2 layers")
    t0 = time.perf_counter()
    ckpt = checkpoint_phase(torch, TRAIN_ARGS)
    ckpt_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spec = phase_spec(torch, base_tokens, kv_tokens["int8"], e2e, kv)
    spec_s = time.perf_counter() - t0
    log(f"  serve phase {serve_s:.1f} s, train phase {train_s:.1f} s, kv phase {kv_s:.1f} s, "
        f"checkpoint phase {ckpt_s:.1f} s, speculative phase {spec_s:.1f} s")

    sources = {
        "paged_decode_attention": (
            "src/repro_torch/kernels/decode_attention/csrc/paged_decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:143", launches),
        "ragged_ffn": (GROUPED_FFN_SM90, "src/repro/kernels/moe_dropless/kernel.py:80",
                       launches),
        "moe_ffn": (GROUPED_FFN_SM90, "src/repro/kernels/moe_ffn/kernel.py:72", train_launches),
        "flash_attention": (FLASH_SM90, "src/repro/kernels/flash_attention/kernel.py:66",
                            {"flash_attention": train["flash"]["launches"]}),
        "quantized_paged_decode_attention": (
            "src/repro_torch/kernels/decode_attention/csrc/quantized_paged_decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:226", kv_launches),
        "decode_attention": ("src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
                             "src/repro/kernels/decode_attention/kernel.py:63", kv_launches),
    }
    kernels = []
    for name, (src, replaces, counts) in sources.items():
        if counts[name] <= 0:
            raise AssertionError(f"{name}: launched no time on its path")
        t = timing[name]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": counts[name], "max_abs_err": errs[name],
                 "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                 "device_ms": t["device_ms"], "library_device_ms": t["library_device_ms"]}
        if src == GROUPED_FFN_SM90:       # the grouped FFN's tensor-core route
            entry.update(device_code="tensor cores (wgmma, TMA), bf16 h hi + lo",
                         entry_point=f"{name}_tc", max_abs_err_split_h=errs[f"{name} split"],
                         cuda_core_ms=t["cuda_core_ms"])
        if src == FLASH_SM90:             # flash attention's tensor-core route
            entry.update(device_code="tensor cores (wgmma, TMA), P from registers as bf16 hi + lo",
                         entry_point="flash_attention_tc",
                         max_abs_err_split_p=errs["flash_attention split"],
                         tc_launches=train["flash"]["tc_launches"],
                         cuda_core_ms=t["cuda_core_ms"],
                         cuda_core_device_ms=t["cuda_core_device_ms"])
        if "plan" in t:                   # the decode kernels' ring and cluster split
            copies = ("TMA boxes of a tensor map, the first pass's issued before the length "
                      "is read"
                      if name == "decode_attention" else "bulk copies of whole KV tiles")
            entry.update(device_code=f"{copies}, into a ring of stages, split over a "
                                     f"thread-block cluster",
                         header=DECODE_SM90, splits=t["plan"][0], stages=t["plan"][1])
        v = spec["timing"].get(name)
        if v is not None:                 # phase 9: the verify step's shape
            entry.update(verify_launches=sum(
                r["launches"][name] for r in spec["greedy"].values()),
                verify_ms=v["ms"], verify_device_ms=v["device_ms"],
                verify_plain_ms=v["plain_ms"], verify_bound_ms=v["bound_ms"],
                verify_library_device_ms=v["library_device_ms"])
        kernels.append(entry)
    print(json.dumps({"serve": e2e, "train": train, "kv": kv, "checkpoint": ckpt,
                      "spec": spec, "build_s": build_s, "serve_s": serve_s,
                      "train_s": train_s, "kv_s": kv_s, "checkpoint_s": ckpt_s,
                      "spec_s": spec_s,
                      "mixed_step_kernels": timing_mixed,
                      "moe_ffn_x180": timing["moe_ffn X=180"],
                      "flash_attention_s256": timing["flash_attention S=256"],
                      "quantized_fp8": timing["quantized_paged_decode_attention fp8"],
                      "paged_splits": timing["splits"], "remeasure": again}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
