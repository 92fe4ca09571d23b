"""Grouped expert FFN over capacity buffers: the CUDA kernel's wrapper
(``repro.kernels.moe_ffn.ops``).

:func:`moe_ffn` is a ``torch.autograd.Function``, as the reference's
``custom_vjp``: its forward runs the plain version in ``ref.py`` on CPU
tensors and launches ``csrc/moe_ffn.cu`` on CUDA tensors, on the current
stream; on ``meta`` tensors (the dry run) it makes the kernel's output and
workspace and launches nothing; on any other device it raises; its backward is autograd through ``ref.py`` (the TPU
kernel has no backward kernel either).  Two routes
(``common.tensor_core_route``): bf16 with M and I multiples of 8 launches
``moe_ffn_tc`` (wgmma, ``kernels/csrc/grouped_ffn_sm90.cuh``; h as bf16
hi + lo planes), the rest ``moe_ffn`` (CUDA cores,
``kernels/csrc/grouped_ffn.cuh``; h in f32).  Neither pads X.
``moe_ffn.launches`` counts the kernel launches, ``moe_ffn.tc_launches``
those of the tensor-core route.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.common import act_code, ref_vjp, tensor_core_route, tile_rows
from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_C = ctypes.c_int
_P = ctypes.c_void_p
# the C signature in csrc/: (dtype, pointers..., sizes..., stream)
_ARGTYPES = [_C] + [_P] * 6 + [_C] * 5 + [_P]
_TC_ARGTYPES = [_P] * 6 + [_C] * 7 + [_P]


def _lib(entry: str = "moe_ffn"):
    fn = getattr(build.load("moe_ffn"), entry)
    if fn.argtypes is None:
        fn.argtypes = _TC_ARGTYPES if entry == "moe_ffn_tc" else _ARGTYPES
        fn.restype = _C
    return fn


def _check(x, w_up, w_gate, w_down):
    E, X, M = x.shape
    ws = [("w_up", w_up), ("w_down", w_down)] + ([("w_gate", w_gate)] if w_gate is not None else [])
    for name, t in ws:
        if t.device != x.device:
            raise ValueError(f"moe_ffn: {name} on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for _, t in ws):
        raise TypeError("moe_ffn: x and the weights must share bf16 or f32")
    I = w_up.shape[-1]
    if (w_up.shape != (E, M, I) or w_down.shape != (E, I, M)
            or (w_gate is not None and w_gate.shape != w_up.shape)):
        raise ValueError(f"moe_ffn: weights {tuple(w_up.shape)}/{tuple(w_down.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if tensor_core_route(x.dtype, M, I):
        tiles = tile_rows(X, w_gate is not None)[1]
        if E * tiles > 65535:
            raise ValueError(f"moe_ffn tensor-core kernel takes E * tiles <= 65535; got E={E}, "
                             f"X={X} ({tiles} tiles)")
    elif E * -(-X // 8) > 65535:
        raise ValueError(f"moe_ffn CUDA-core kernel takes E * ceil(X / 8) <= 65535; got E={E}, "
                         f"X={X}")
    for name, t in ws + [("x", x)]:
        if not t.is_contiguous():
            raise ValueError(f"moe_ffn: {name} must be contiguous")


def _buffers(x, I: int, tensor_cores: bool):
    """The kernel's output and its h workspace: (2, E*X, I) bf16 hi + lo
    planes on the tensor-core route, (E*X, I) f32 on the CUDA cores."""
    E, X, _ = x.shape
    y = torch.empty_like(x)
    if tensor_cores:
        return y, torch.empty((2, E * X, I), dtype=torch.bfloat16, device=x.device)
    return y, torch.empty((E * X, I), dtype=torch.float32, device=x.device)


def _launch(x, w_up, w_gate, w_down, activation):
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"moe_ffn: no kernel for device {x.device}")
    _check(x, w_up, w_gate, w_down)
    E, X, M = x.shape
    I = w_up.shape[-1]
    tensor_cores = tensor_core_route(x.dtype, M, I)
    y, h = _buffers(x, I, tensor_cores)
    if x.device.type == "meta":         # the dry run: the kernel's tensors, no launch
        return y
    act = act_code(activation, w_gate is not None)
    gate = w_gate.data_ptr() if w_gate is not None else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if tensor_cores:
            n, tiles = tile_rows(X, w_gate is not None)
            err = _lib("moe_ffn_tc")(x.data_ptr(), w_up.data_ptr(), gate, w_down.data_ptr(),
                                     h.data_ptr(), y.data_ptr(), E, X, M, I, act, n, tiles,
                                     stream)
        else:
            err = _lib()(_DTYPE_CODE[x.dtype], x.data_ptr(), w_up.data_ptr(), gate,
                         w_down.data_ptr(), h.data_ptr(), y.data_ptr(), E, X, M, I, act, stream)
    if err:
        raise RuntimeError(f"moe_ffn kernel launch failed: cudaError {err}")
    moe_ffn.launches += 1
    moe_ffn.tc_launches += bool(tensor_cores)
    return y


class _MoeFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_up, w_gate, w_down, activation):
        ctx.activation = activation
        ctx.save_for_backward(x, w_up, w_gate, w_down)
        if x.device.type == "cpu":
            return moe_ffn_ref(x, w_up, w_gate, w_down, activation)
        return _launch(x, w_up, w_gate, w_down, activation)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        grads = ref_vjp(lambda *a: moe_ffn_ref(*a, ctx.activation), saved,
                        ctx.needs_input_grad[:4], grad)
        return grads + (None,)


def moe_ffn(x: torch.Tensor, w_up: torch.Tensor, w_gate: Optional[torch.Tensor],
            w_down: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    """x: (E, X, M) dispatched tokens; returns (E, X, M)."""
    return _MoeFFN.apply(x, w_up, w_gate, w_down, activation)


counters.counted(moe_ffn, "launches", "tc_launches")

__all__ = ["moe_ffn", "moe_ffn_ref"]
