"""The dropless combine: each token's routed rows of the ragged FFN's
output, gate-weighted and summed, in place of the scatter-add the
reference's dispatcher ends with (``.at[gi, tok].add(out * gate)``).

:func:`ragged_combine` is a ``torch.autograd.Function``: its forward runs
the plain version (``ref.py::ragged_combine_ref``) on CPU tensors and
launches ``csrc/ragged_combine.cu`` on CUDA tensors, on the current
stream; on ``meta`` tensors (the dry run) it makes the output and
launches nothing; on any other device it raises.  Its backward is
``ref.py::ragged_combine_grads`` on every device (torch ops: the
reference has no kernel here).  ``ragged_combine.launches`` counts its
calls that launched the kernel.

The row map (``ref.py::index_row_map`` / ``slot_row_map``) names each
token's routed rows, so the kernel reads those rows only, in the order of
the token's choices: no sort, and a padding or dead row is never read.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.moe_dropless.ref import ragged_combine_grads, ragged_combine_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_C = ctypes.c_int
_P = ctypes.c_void_p
_L = ctypes.c_longlong
# (dtype, out, gate, rows, y, G, T, K, M, five strides, stream)
_ARGTYPES = [_C] + [_P] * 4 + [_C] * 4 + [_L] * 5 + [_P]


def _lib():
    fn = build.load("ragged_combine").ragged_combine
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _C
    return fn


def _check(out, gate, rows):
    if (out.dim() != 3 or gate.shape != out.shape[:2] or rows.dim() != 3
            or rows.shape[0] != out.shape[0]):
        raise ValueError(f"ragged_combine: out {tuple(out.shape)}, gate {tuple(gate.shape)}, "
                         f"rows {tuple(rows.shape)} are not (G, R, M), (G, R), (G, T, K)")
    for name, t in (("gate", gate), ("rows", rows)):
        if t.device != out.device:
            raise ValueError(f"ragged_combine: {name} on {t.device}, out on {out.device}")
    if out.dtype not in _DTYPE_CODE or gate.dtype != torch.float32 or rows.dtype != torch.int32:
        raise TypeError("ragged_combine: out must be bf16 or f32, gate f32 and rows int32")
    if out.stride(-1) != 1 or gate.stride(-1) != 1 or rows.stride(-1) != 1:
        raise ValueError("ragged_combine: out, gate and rows need a unit last stride")


def _launch(out, gate, rows):
    if out.device.type not in ("cuda", "meta"):
        raise ValueError(f"ragged_combine: no kernel for device {out.device}")
    n = 16 // out.element_size()          # the kernel's 16-byte vectors
    if out.data_ptr() % 16 or any(d % n for d in (out.shape[2], out.stride(0), out.stride(1))):
        raise ValueError(f"ragged_combine kernel needs 16-byte aligned rows: M, the group and "
                         f"row strides multiples of {n}; got out {tuple(out.shape)}, strides "
                         f"{out.stride()}")
    G, R, M = out.shape
    T, K = rows.shape[1:]
    y = torch.empty((G, T, M), dtype=out.dtype, device=out.device)
    if out.device.type == "meta":       # the dry run: the output, no launch
        return y
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _lib()(_DTYPE_CODE[out.dtype], out.data_ptr(), gate.data_ptr(), rows.data_ptr(),
                     y.data_ptr(), G, T, K, M, out.stride(0), out.stride(1), gate.stride(0),
                     rows.stride(0), rows.stride(1), stream)
    if err:
        raise RuntimeError(f"ragged_combine kernel launch failed: cudaError {err}")
    ragged_combine.launches += 1
    return y


class _RaggedCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, gate, rows):
        ctx.save_for_backward(out, gate, rows)
        if out.device.type == "cpu":
            return ragged_combine_ref(out, gate, rows)
        return _launch(out, gate, rows)

    @staticmethod
    def backward(ctx, grad):
        out, gate, rows = ctx.saved_tensors
        d_out, d_gate = ragged_combine_grads(out, gate, rows, grad)
        return (d_out if ctx.needs_input_grad[0] else None,
                d_gate if ctx.needs_input_grad[1] else None, None)


def ragged_combine(out: torch.Tensor, gate: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """out: (G, R, M) the ragged FFN's rows (bf16 or f32, unit element
    stride; on the card every row 16-byte aligned: M and the group and row
    strides multiples of 8 bf16 or 4 f32); gate: (G, R) f32; rows: (G, T, K) int32
    row map (any group and token strides, unit choice stride), -1 where a
    choice is not routed.  Returns (G, T, M) in out's dtype: y[g, t] = sum
    over the routed k of out[g, r] * gate[g, r], r = rows[g, t, k]."""
    _check(out, gate, rows)
    return _RaggedCombine.apply(out, gate, rows)


counters.counted(ragged_combine, "launches")

__all__ = ["ragged_combine", "ragged_combine_ref"]
