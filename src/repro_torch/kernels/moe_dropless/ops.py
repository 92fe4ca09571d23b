"""Ragged grouped FFN: block-size rules and the CUDA kernel's wrapper
(``repro.kernels.moe_dropless.ops``).

``pick_block_rows`` and ``padded_rows`` are kept bit-exact with the
reference: the sorted, block-padded row layout is part of the contract
the routing tests compare.  :func:`ragged_ffn` is a
``torch.autograd.Function``, as the reference's ``custom_vjp``: its
forward runs the plain version in ``ref.py`` on CPU tensors and launches
``csrc/ragged_ffn.cu`` (two grouped passes, h in device memory) on CUDA
tensors, on the current stream; on ``meta`` tensors (the dry run) it makes
the kernel's output and workspace and launches nothing; on any other
device it raises; its backward is autograd
through ``ref.py`` (``block_expert`` gets no gradient).

The liveness (``live``, optional): one tag per row, >= 0 on a routed row
(the ragged view's ``token``; on a mesh rank the received expert ids, -1
on a slot's padding).  A block with no routed row is dead: the kernel
never reads its ``x`` or its expert id and writes its rows as exactly 0.
Without ``live`` every block is computed, as the reference computes the
trailing padding blocks.  Either way the kernel's work is a list of tiles
of up to ``tile`` rows of one expert, its live blocks gathered from
anywhere in ``x``, built on the device by the kernel's own prologue (no
read to the host): an expert's weight tiles are read once a tile, not
once a block.  ``tile`` comes from static sizes (:func:`ragged_tile_rows`),
never from the data.

Two routes (``common.tensor_core_route``): bf16 launches ``ragged_ffn_tc``
(wgmma, ``kernels/csrc/grouped_ffn_sm90.cuh``: the prologue, then a
persistent grid of the SM count a pass walking the work list; h as bf16
hi + lo planes), f32 ``ragged_ffn`` (CUDA cores,
``kernels/csrc/grouped_ffn.cuh``, a CTA an 8-row chunk, dead chunks
written as 0; h in f32).  ``ragged_ffn.launches`` counts its calls that
launched a kernel, ``ragged_ffn.tc_launches`` those of the tensor-core
route.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.common import (
    TC_TILE_ROWS,
    act_code,
    ref_vjp,
    tensor_core_route,
    tile_rows,
)
from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_C = ctypes.c_int
_P = ctypes.c_void_p
# the C signatures in csrc/: (dtype, pointers..., the liveness, pointers, sizes..., stream)
_LIVE = [_P, _C, _C, _C]                  # tags, tag bytes, rows a tag segment, segment stride
_ARGTYPES = [_C] + [_P] * 5 + _LIVE + [_P] * 2 + [_C] * 5 + [_P]
_TC_ARGTYPES = [_P] * 5 + _LIVE + [_P, _C, _P, _C] + [_P] * 2 + [_C] * 8 + [_P]


def pick_block_rows(n_choices: int, num_experts: int, max_block: int = 128) -> int:
    """Largest power of two <= max_block whose worst-case segment padding
    (one block per expert) does not exceed the real rows; floor 8."""
    bx = max_block
    while bx > 8 and num_experts * bx > max(n_choices, 1):
        bx //= 2
    return bx


def padded_rows(n_choices: int, num_experts: int, block_rows: int) -> int:
    """Static row count of the sorted+padded ragged buffer."""
    n = n_choices + num_experts * (block_rows - 1)
    return -(-n // block_rows) * block_rows


def ragged_tile_rows(rows: float, block_rows: int, gated: bool) -> int:
    """The tensor-core route's tile width (wgmma N) for about ``rows``
    rows of one expert in a launch (over all its groups): whole blocks, at
    least one, within the widths the header instantiates and the register
    cap (128 rows gated, 192 not; a block wider than that is cut, as
    ``tile_rows`` cuts it).  An expert with more rows takes several
    tiles."""
    cap = 128 if gated else 192
    want = block_rows * max(1, -(-math.ceil(rows) // block_rows))
    return tile_rows(min(want, max(cap, block_rows)), gated)[0]


def workspace_ints(n_blocks: int, block_rows: int, tile: int, col_tiles: int) -> int:
    """int32 words of the tensor-core route's work list
    (``grouped_ffn_sm90.cuh::ragged_work_ints``): the item and dead-block
    counts, an int4 for each item there can be (one a segment of
    min(bx, n) rows at most), the live blocks sorted by expert, the dead
    blocks, each block's expert or -1, and a counter for each (item,
    column tile) of a split reduction."""
    items = n_blocks * (block_rows // min(block_rows, tile))
    return 4 + 4 * items + 3 * n_blocks + items * col_tiles


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The card's SM count: the persistent passes' grid."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib(entry: str = "ragged_ffn"):
    fn = getattr(build.load("ragged_ffn"), entry)
    if fn.argtypes is None:
        fn.argtypes = _TC_ARGTYPES if entry == "ragged_ffn_tc" else _ARGTYPES
        fn.restype = _C
    return fn


def _check(x, block_expert, w_up, w_gate, w_down, block_x, live=None, tile=0):
    N, M = x.shape
    E, Mw, I = w_up.shape
    ws = [("w_up", w_up), ("w_down", w_down)] + ([("w_gate", w_gate)] if w_gate is not None else [])
    for name, t in ws + [("block_expert", block_expert)] + ([("live", live)] if live is not None
                                                            else []):
        if t.device != x.device:
            raise ValueError(f"ragged_ffn: {name} on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for _, t in ws):
        raise TypeError("ragged_ffn: x and the weights must share bf16 or f32")
    if block_expert.dtype != torch.int32:
        raise TypeError("ragged_ffn: block_expert must be int32")
    if Mw != M or w_down.shape != (E, I, M) or (w_gate is not None and w_gate.shape != w_up.shape):
        raise ValueError(f"ragged_ffn: weights {tuple(w_up.shape)}/{tuple(w_down.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if block_x % 8 or M % 8 or I % 8:
        raise ValueError(f"ragged_ffn kernel needs block_x, M, I multiples of 8; got "
                         f"block_x={block_x}, M={M}, I={I}")
    if live is not None:
        if live.dtype not in (torch.int32, torch.int64):
            raise TypeError("ragged_ffn: live must be int32 or int64")
        if live.numel() != N or live.dim() not in (1, 2) or live.stride(-1) != 1:
            raise ValueError(f"ragged_ffn: live {tuple(live.shape)} (strides {live.stride()}) "
                             f"is not one tag a row of {N} in (segments, rows) with unit "
                             f"row stride")
    if tensor_core_route(x.dtype, M, I):
        cap = 128 if w_gate is not None else 192
        if tile and (tile not in TC_TILE_ROWS or tile > cap or block_x % min(block_x, tile)):
            raise ValueError(f"ragged_ffn: tile {tile} is not a width in {TC_TILE_ROWS} "
                             f"up to {cap} that cuts block_x={block_x} evenly")
        if E > 1024:
            raise ValueError(f"ragged_ffn tensor-core kernel sorts at most 1024 experts; got {E}")
    elif N // 8 > 65535:
        raise ValueError(f"ragged_ffn CUDA-core kernel takes N <= 524280; got N={N}")
    for name, t in ws + [("x", x), ("block_expert", block_expert)]:
        if not t.is_contiguous():
            raise ValueError(f"ragged_ffn: {name} must be contiguous")


def _buffers(x, I: int, tensor_cores: bool):
    """The kernel's output and its h workspace: (2, N, I) bf16 hi + lo
    planes on the tensor-core route, (N, I) f32 on the CUDA cores."""
    N = x.shape[0]
    y = torch.empty_like(x)
    if tensor_cores:
        return y, torch.empty((2, N, I), dtype=torch.bfloat16, device=x.device)
    return y, torch.empty((N, I), dtype=torch.float32, device=x.device)


def _live_args(live):
    """The liveness as the C entries take it: (tags, tag bytes, rows a
    segment, a segment's stride in tags); (None, 0, 0, 0) without it."""
    if live is None:
        return None, 0, 0, 0
    segs = live if live.dim() == 2 else live.reshape(1, -1)
    return live.data_ptr(), live.element_size(), segs.shape[1], segs.stride(0)


def _launch(x, block_expert, w_up, w_gate, w_down, activation, block_x, live, tile):
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ragged_ffn: no kernel for device {x.device}")
    _check(x, block_expert, w_up, w_gate, w_down, block_x, live, tile)
    N, M = x.shape
    E, _, I = w_up.shape
    tensor_cores = tensor_core_route(x.dtype, M, I)
    y, h = _buffers(x, I, tensor_cores)
    n = tile or tile_rows(block_x, w_gate is not None)[0]
    words = workspace_ints(N // block_x, block_x, n, -(-max(M, I) // 128))
    work = torch.empty(words, dtype=torch.int32, device=x.device) if tensor_cores else None
    if x.device.type == "meta":         # the dry run: the kernel's tensors, no launch
        return y
    act = act_code(activation, w_gate is not None)
    gate = w_gate.data_ptr() if w_gate is not None else None
    tags = _live_args(live)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if tensor_cores:
            ctas = _sm_count(x.device)
            # the split reductions' f32 scratch: an SM's worth of tile slices, 128 rows a
            # tile at least (a pass splits only as far as its slices fit)
            partial = torch.empty(ctas * 256 * max(n, 128), dtype=torch.float32,
                                  device=x.device)
            err = _lib("ragged_ffn_tc")(
                x.data_ptr(), w_up.data_ptr(), gate, w_down.data_ptr(), block_expert.data_ptr(),
                *tags, work.data_ptr(), words, partial.data_ptr(), partial.numel(),
                h.data_ptr(), y.data_ptr(), N, M, I, E, block_x, act, n, ctas, stream)
        else:
            err = _lib()(_DTYPE_CODE[x.dtype], x.data_ptr(), w_up.data_ptr(), gate,
                         w_down.data_ptr(), block_expert.data_ptr(), *tags, h.data_ptr(),
                         y.data_ptr(), N, M, I, block_x, act, stream)
    if err:
        raise RuntimeError(f"ragged_ffn kernel launch failed: cudaError {err}")
    ragged_ffn.launches += 1
    ragged_ffn.tc_launches += bool(tensor_cores)
    return y


class _RaggedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, block_expert, w_up, w_gate, w_down, activation, block_x, live, tile):
        ctx.activation = activation
        ctx.save_for_backward(x, block_expert, w_up, w_gate, w_down, live)
        if x.device.type == "cpu":
            return ragged_ffn_ref(x, block_expert, w_up, w_gate, w_down, activation, live)
        return _launch(x, block_expert, w_up, w_gate, w_down, activation, block_x, live, tile)

    @staticmethod
    def backward(ctx, grad):
        x, be, w_up, w_gate, w_down, live = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        dx, _, dup, dgate, ddown = ref_vjp(
            lambda *a: ragged_ffn_ref(*a, ctx.activation, live),
            (x, be, w_up, w_gate, w_down), (needs[0], False) + needs[2:], grad)
        return dx, None, dup, dgate, ddown, None, None, None, None


def ragged_ffn(x: torch.Tensor, block_expert: torch.Tensor, w_up: torch.Tensor,
               w_gate: Optional[torch.Tensor], w_down: torch.Tensor,
               activation: str = "swiglu", block_x: int = 128,
               live: Optional[torch.Tensor] = None, tile: int = 0) -> torch.Tensor:
    """x: (N, M) expert-sorted rows, N % block_x == 0; block_expert:
    (N / block_x,) int32 expert per row block; weights (E, M, I) /
    (E, I, M).  live: None, or one int32 / int64 tag a row, (N,) or
    (segments, rows) with unit row stride (any segment stride), >= 0 on a
    routed row: rows of blocks without one come out 0.  tile: the
    tensor-core route's tile width (``ragged_tile_rows``; 0: one block).
    Returns (N, M)."""
    N, M = x.shape
    if N % block_x or block_expert.shape != (N // block_x,):
        raise ValueError(f"ragged_ffn: N={N}, block_x={block_x}, "
                         f"block_expert {tuple(block_expert.shape)}")
    return _RaggedFFN.apply(x, block_expert, w_up, w_gate, w_down, activation, block_x, live,
                            tile)


counters.counted(ragged_ffn, "launches", "tc_launches")

__all__ = ["ragged_ffn", "ragged_ffn_ref", "pick_block_rows", "padded_rows", "ragged_tile_rows"]
