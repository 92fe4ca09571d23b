"""Grouped expert FFN over capacity buffers: the CUDA kernel's wrapper
(``repro.kernels.moe_ffn.ops``).

:func:`moe_ffn` is a ``torch.autograd.Function``, as the reference's
``custom_vjp``: its forward runs the plain version in ``ref.py`` on CPU
tensors and launches ``csrc/moe_ffn.cu`` on CUDA tensors, on the current
stream, or raises; its backward is autograd through ``ref.py`` (the TPU
kernel has no backward kernel either).  The kernel masks each expert's
last 8-row chunk, so X needs no padding (the reference pads rows to its
block); any I.  ``moe_ffn.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import act_code, ref_vjp
from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_C = ctypes.c_int
_P = ctypes.c_void_p
# the C signature in csrc/: (dtype, pointers..., sizes..., stream)
_ARGTYPES = [_C] + [_P] * 6 + [_C] * 5 + [_P]


def _lib():
    fn = build.load("moe_ffn").moe_ffn
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
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
    if E * -(-X // 8) > 65535:
        raise ValueError(f"moe_ffn kernel takes E * ceil(X / 8) <= 65535; got E={E}, X={X}")
    for name, t in ws + [("x", x)]:
        if not t.is_contiguous():
            raise ValueError(f"moe_ffn: {name} must be contiguous")


def _launch(x, w_up, w_gate, w_down, activation):
    if x.device.type != "cuda":
        raise ValueError(f"moe_ffn: no kernel for device {x.device}")
    _check(x, w_up, w_gate, w_down)
    E, X, M = x.shape
    I = w_up.shape[-1]
    h = torch.empty((E * X, I), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w_up.data_ptr(),
                 w_gate.data_ptr() if w_gate is not None else None, w_down.data_ptr(),
                 h.data_ptr(), y.data_ptr(), E, X, M, I,
                 act_code(activation, w_gate is not None), stream)
    if err:
        raise RuntimeError(f"moe_ffn kernel launch failed: cudaError {err}")
    moe_ffn.launches += 1
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


moe_ffn.launches = 0

__all__ = ["moe_ffn", "moe_ffn_ref"]
