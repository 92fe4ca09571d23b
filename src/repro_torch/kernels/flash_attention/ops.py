"""Flash attention forward: the CUDA kernel's wrapper
(``repro.kernels.flash_attention.ops``), in the public (B, S, H, D) layout.

On CPU tensors :func:`flash_attention` runs the plain version in
``ref.py``; on CUDA tensors it launches ``csrc/flash_attention.cu`` on the
current stream (reading (B, S, H, D) directly, so no transposes); on
``meta`` tensors (the dry run) it makes the kernel's output and launches
nothing; on any other device it raises.  Two routes (``common.flash_tensor_core_route``): bf16 with D in
(64, 128) launches ``flash_attention_tc`` (TMA and wgmma,
``kernels/csrc/flash_attention_sm90.cuh``; P as bf16 hi + lo, the numerics
of ``ref.attention_split_ref``), the rest ``flash_attention`` (CUDA cores,
f32 P).  The reference defines no gradient for its flash kernel (a
``pallas_call`` with no VJP), so neither does the port: the wrapper raises
when autograd would need one.  ``flash_attention.launches`` counts the
kernel launches, ``flash_attention.tc_launches`` those of the tensor-core
route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.common import flash_tensor_core_route
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_C = ctypes.c_int
_P = ctypes.c_void_p
# the C signatures in csrc/: (dtype, pointers..., sizes..., stream)
_ARGTYPES = [_C] + [_P] * 4 + [_C] * 6 + [_P]
_TC_ARGTYPES = [_P] * 4 + [_C] * 6 + [_P]


def _lib(entry: str = "flash_attention"):
    fn = getattr(build.load("flash_attention"), entry)
    if fn.argtypes is None:
        fn.argtypes = _TC_ARGTYPES if entry == "flash_attention_tc" else _ARGTYPES
        fn.restype = _C
    return fn


def _check(q, k, v):
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share bf16 or f32, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    B, S, Hq, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if Hq % k.shape[2] or D not in (16, 32, 64, 128):
        raise ValueError(f"flash_attention kernel takes Hq % Hkv == 0 and D in "
                         f"(16, 32, 64, 128); got Hq={Hq}, Hkv={k.shape[2]}, D={D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    if flash_tensor_core_route(q.dtype, D):
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention tensor-core kernel: {name} is not 16-byte "
                                 f"aligned (TMA reads it)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, D); k/v: (B, S, Hkv, D) -> (B, S, Hq, D)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward (the reference's flash "
                           "kernel defines none): call it under torch.no_grad()")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v)
    B, S, Hq, D = q.shape
    tensor_cores = flash_tensor_core_route(q.dtype, D)
    o = torch.empty_like(q)
    if q.device.type == "meta":         # the dry run: the kernel's output, no launch
        return o
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tensor_cores:
            err = _lib("flash_attention_tc")(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             o.data_ptr(), B, S, Hq, k.shape[2], D, int(causal),
                                             stream)
        else:
            err = _lib()(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), B, S, Hq, k.shape[2], D, int(causal), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    flash_attention.tc_launches += bool(tensor_cores)
    return o


counters.counted(flash_attention, "launches", "tc_launches")

__all__ = ["flash_attention", "attention_ref"]
