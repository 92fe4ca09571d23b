"""Flash attention forward: the CUDA kernel's wrapper
(``repro.kernels.flash_attention.ops``), in the public (B, S, H, D) layout.

On CPU tensors :func:`flash_attention` runs the plain version in
``ref.py``; on CUDA tensors it launches ``csrc/flash_attention.cu`` on the
current stream (reading (B, S, H, D) directly, so no transposes) or
raises.  The reference defines no gradient for its flash kernel (a
``pallas_call`` with no VJP), so neither does the port: the wrapper raises
when autograd would need one.  ``flash_attention.launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_C = ctypes.c_int
_P = ctypes.c_void_p
# the C signature in csrc/: (dtype, pointers..., sizes..., stream)
_ARGTYPES = [_C] + [_P] * 4 + [_C] * 6 + [_P]


def _lib():
    fn = build.load("flash_attention").flash_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, Hq, D); k/v: (B, S, Hkv, D) -> (B, S, Hq, D)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward (the reference's flash "
                           "kernel defines none): call it under torch.no_grad()")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _check(q, k, v)
    B, S, Hq, D = q.shape
    o = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, S, Hq, k.shape[2], D, int(causal), stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0

__all__ = ["flash_attention", "attention_ref"]
