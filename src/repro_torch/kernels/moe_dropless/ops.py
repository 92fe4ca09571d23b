"""Ragged grouped FFN: block-size rules and the CUDA kernel's wrapper
(``repro.kernels.moe_dropless.ops``).

``pick_block_rows`` and ``padded_rows`` are kept bit-exact with the
reference: the sorted, block-padded row layout is part of the contract
the routing tests compare.  :func:`ragged_ffn` is a
``torch.autograd.Function``, as the reference's ``custom_vjp``: its
forward runs the plain version in ``ref.py`` on CPU tensors and launches
``csrc/ragged_ffn.cu`` (two grouped passes with an f32 scratch for the
intermediate) on CUDA tensors, on the current stream, or raises; its
backward is autograd through ``ref.py`` (``block_expert`` gets no
gradient).  ``ragged_ffn.launches`` counts its calls that launched the
kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import act_code, ref_vjp
from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_C = ctypes.c_int
_P = ctypes.c_void_p
# the C signature in csrc/: (dtype, pointers..., sizes..., stream)
_ARGTYPES = [_C] + [_P] * 7 + [_C] * 5 + [_P]


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


def _lib():
    fn = build.load("ragged_ffn").ragged_ffn
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _C
    return fn


def _check(x, block_expert, w_up, w_gate, w_down, block_x):
    N, M = x.shape
    E, Mw, I = w_up.shape
    ws = [("w_up", w_up), ("w_down", w_down)] + ([("w_gate", w_gate)] if w_gate is not None else [])
    for name, t in ws + [("block_expert", block_expert)]:
        if t.device != x.device:
            raise ValueError(f"ragged_ffn: {name} on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for _, t in ws):
        raise TypeError("ragged_ffn: x and the weights must share bf16 or f32")
    if block_expert.dtype != torch.int32:
        raise TypeError("ragged_ffn: block_expert must be int32")
    if Mw != M or w_down.shape != (E, I, M) or (w_gate is not None and w_gate.shape != w_up.shape):
        raise ValueError(f"ragged_ffn: weights {tuple(w_up.shape)}/{tuple(w_down.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if block_x % 8 or M % 8 or I % 8 or N // 8 > 65535:
        raise ValueError(f"ragged_ffn kernel needs block_x, M, I multiples of 8 and "
                         f"N <= 524280; got block_x={block_x}, M={M}, I={I}, N={N}")
    for name, t in ws + [("x", x), ("block_expert", block_expert)]:
        if not t.is_contiguous():
            raise ValueError(f"ragged_ffn: {name} must be contiguous")


def _launch(x, block_expert, w_up, w_gate, w_down, activation, block_x):
    if x.device.type != "cuda":
        raise ValueError(f"ragged_ffn: no kernel for device {x.device}")
    _check(x, block_expert, w_up, w_gate, w_down, block_x)
    N, M = x.shape
    I = w_up.shape[2]
    h = torch.empty((N, I), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w_up.data_ptr(),
                 w_gate.data_ptr() if w_gate is not None else None, w_down.data_ptr(),
                 block_expert.data_ptr(), h.data_ptr(), y.data_ptr(),
                 N, M, I, block_x, act_code(activation, w_gate is not None), stream)
    if err:
        raise RuntimeError(f"ragged_ffn kernel launch failed: cudaError {err}")
    ragged_ffn.launches += 1
    return y


class _RaggedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, block_expert, w_up, w_gate, w_down, activation, block_x):
        ctx.activation = activation
        ctx.save_for_backward(x, block_expert, w_up, w_gate, w_down)
        if x.device.type == "cpu":
            return ragged_ffn_ref(x, block_expert, w_up, w_gate, w_down, activation)
        return _launch(x, block_expert, w_up, w_gate, w_down, activation, block_x)

    @staticmethod
    def backward(ctx, grad):
        x, be, w_up, w_gate, w_down = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        dx, _, dup, dgate, ddown = ref_vjp(
            lambda *a: ragged_ffn_ref(*a, ctx.activation),
            (x, be, w_up, w_gate, w_down), (needs[0], False) + needs[2:], grad)
        return dx, None, dup, dgate, ddown, None, None


def ragged_ffn(x: torch.Tensor, block_expert: torch.Tensor, w_up: torch.Tensor,
               w_gate: Optional[torch.Tensor], w_down: torch.Tensor,
               activation: str = "swiglu", block_x: int = 128) -> torch.Tensor:
    """x: (N, M) expert-sorted rows, N % block_x == 0; block_expert:
    (N / block_x,) int32 expert per row block; weights (E, M, I) /
    (E, I, M).  Returns (N, M)."""
    N, M = x.shape
    if N % block_x or block_expert.shape != (N // block_x,):
        raise ValueError(f"ragged_ffn: N={N}, block_x={block_x}, "
                         f"block_expert {tuple(block_expert.shape)}")
    return _RaggedFFN.apply(x, block_expert, w_up, w_gate, w_down, activation, block_x)


ragged_ffn.launches = 0

__all__ = ["ragged_ffn", "ragged_ffn_ref", "pick_block_rows", "padded_rows"]
