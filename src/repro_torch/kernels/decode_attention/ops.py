"""Paged decode attention: the CUDA kernel's wrapper and the K/V write
(``repro.kernels.decode_attention.ops``).

On CPU tensors the wrapper runs the plain version in ``ref.py``; on CUDA
tensors it launches ``csrc/paged_decode_attention.cu`` on the current
stream or raises.  ``paged_decode_attention.launches`` counts the kernel
launches (and nothing else).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_C = ctypes.c_int
_P = ctypes.c_void_p
# the C signature in csrc/: (dtype, pointers..., sizes..., stream)
_ARGTYPES = [_C] + [_P] * 6 + [_C] * 6 + [_P]


def _lib():
    lib = build.load("paged_decode_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _C
    return fn


def _check(q, k_pool, v_pool, block_tables, lengths):
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"paged_decode_attention: {name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention: q/pools must share bf16 or f32, got "
                        f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and lengths must be int32")
    N, Hq, D = q.shape
    P, Hkv, bs, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != D:
        raise ValueError(f"paged_decode_attention: pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} vs q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != N or lengths.shape != (N,):
        raise ValueError("paged_decode_attention: block_tables (N, MB), lengths (N,)")
    if Hq % Hkv or Hq // Hkv not in (1, 2, 4, 8) or D not in (32, 64, 128):
        raise ValueError(f"paged_decode_attention kernel takes G in (1, 2, 4, 8) and "
                         f"D in (32, 64, 128); got Hq={Hq}, Hkv={Hkv}, D={D}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           block_tables: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """q: (N, Hq, D) one query per row; k_pool/v_pool: (P, Hkv, bs, D);
    block_tables: (N, MB) int32 pool block ids; lengths: (N,) int32 valid
    context per row (0 => output 0).  Returns (N, Hq, D)."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device {q.device}")
    _check(q, k_pool, v_pool, block_tables, lengths)
    N, Hq, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 N, Hkv, Hq // Hkv, D, bs, block_tables.shape[1], stream)
    if err:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: cudaError {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_update_attention(q, k, v, k_pool, v_pool, write_blocks, write_offsets,
                           block_tables, lengths):
    """One serving step's K/V write, then paged attention over it.

    The write is plain PyTorch and **in place**: ``k_pool[wb, :, wo] = k``
    (the reference returns new pools that its jit donates; here the pools
    are simply updated).  The two advanced indices separated by a slice
    follow NumPy's rule, as JAX does: the indexed view is ``(N, Hkv, D)``,
    the layout of ``k``.  Masked rows all write the garbage block at
    offset 0, which no row reads under a nonzero length, so the order in
    which those duplicate writes land does not matter.

    q: (N, Hq, D); k/v: (N, Hkv, D); pools: (P, Hkv, bs, D).
    Returns ``(out, k_pool, v_pool)``.
    """
    wb, wo = write_blocks.long(), write_offsets.long()
    k_pool[wb, :, wo] = k.to(k_pool.dtype)
    v_pool[wb, :, wo] = v.to(v_pool.dtype)
    out = paged_decode_attention(q, k_pool, v_pool, block_tables, lengths)
    return out, k_pool, v_pool


__all__ = ["paged_decode_attention", "paged_decode_attention_ref",
           "paged_update_attention"]
