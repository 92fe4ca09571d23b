"""KV-cache quantization policies: per-block-per-head absmax scaling
(``repro.quant.policy``).

A :class:`KVQuantPolicy` describes how a paged K/V pool stores its
tokens: the device pool holds int8 *codes* (``fp8`` stores float8_e4m3fn
bit patterns in the int8 carrier) plus a per-(layer, block, kv_head)
float32 *scale* pool indexed by the same block table.  A stored value
decodes as ``decode(code) * scale``, with the scale ``absmax / qmax`` over
every row the block has held, so the elementwise error is bounded by
:meth:`KVQuantPolicy.error_bound` (scale / 2 for int8, scale * 16 for fp8).
:func:`quant_write_kv` grows a block's scale when new rows need it and
re-encodes the block's resident codes at the new scale first.

The encoders give codes bit-equal to the reference's: int8 rounds half to
even and clips to +-127; fp8 clips to +-448 (e4m3fn has no infinity, and a
cast beyond its range gives NaN) and casts with round-to-nearest-even.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

__all__ = [
    "KVQuantPolicy", "register_kv_quant", "get_kv_quant", "quant_write_kv",
    "check_quant_roundtrip",
]

# Guard for divisions by a block scale: all-zero blocks have scale 0.
_TINY = 1e-30


class KVQuantPolicy:
    """One KV quantization scheme: ``name`` (registry key), ``quantized``
    (False only for ``none``), ``qmax`` (largest code magnitude; the scale
    is ``absmax / qmax``), the encoder/decoder pair and ``error_ulps``
    (the elementwise bound in units of the scale)."""

    def __init__(self, name: str, *, quantized: bool, qmax: float,
                 encode: Optional[Callable] = None,
                 decode: Optional[Callable] = None,
                 error_ulps: float = 0.5):
        self.name = name
        self.quantized = quantized
        self.qmax = qmax
        self._encode = encode
        self._decode = decode
        self.error_ulps = error_ulps
        self.pool_dtype = torch.int8

    def __repr__(self):
        return f"KVQuantPolicy({self.name!r})"

    def encode(self, u: torch.Tensor) -> torch.Tensor:
        """Scaled values (value / scale) -> int8 codes."""
        return self._encode(u)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """int8 codes -> float32 scaled values."""
        return self._decode(codes)

    def error_bound(self, scale):
        """Elementwise |dequant - value| bound for a block with ``scale``."""
        return scale * self.error_ulps


_REGISTRY: Dict[str, KVQuantPolicy] = {}


def register_kv_quant(policy: KVQuantPolicy) -> KVQuantPolicy:
    _REGISTRY[policy.name] = policy
    return policy


def get_kv_quant(name: str) -> KVQuantPolicy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown kv_quant {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}") from None


# -- built-in policies -------------------------------------------------------

def _int8_encode(u):
    return u.round().clamp(-127.0, 127.0).to(torch.int8)


def _int8_decode(codes):
    return codes.float()


def _fp8_encode(u):
    return u.float().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).view(torch.int8)


def _fp8_decode(codes):
    return codes.view(torch.float8_e4m3fn).float()


NONE = register_kv_quant(KVQuantPolicy("none", quantized=False, qmax=0.0))
INT8 = register_kv_quant(KVQuantPolicy(
    "int8", quantized=True, qmax=127.0,
    encode=_int8_encode, decode=_int8_decode, error_ulps=0.5))
FP8 = register_kv_quant(KVQuantPolicy(
    "fp8", quantized=True, qmax=448.0,
    encode=_fp8_encode, decode=_fp8_decode, error_ulps=16.0))


# -- pool write primitive ----------------------------------------------------

def quant_write_kv(codes_pool: torch.Tensor, scales: torch.Tensor, x: torch.Tensor,
                   write_blocks: torch.Tensor, write_offsets: torch.Tensor,
                   *, policy: KVQuantPolicy):
    """Scatter new token rows into a quantized pool, maintaining scales,
    **in place** (the reference returns new arrays that its jit donates).

    codes_pool (P, Hkv, bs, D) int8; scales (P, Hkv) float32; x (N, Hkv, D);
    write_blocks / write_offsets (N,) destination coordinates.  Returns
    ``(codes_pool, scales)``.

    The rewrite rule, as the reference's: a block written at offset 0 this
    step is *fresh* and restarts its scale from 0 (the allocator hands out
    blocks empty and rows fill in order); each touched block's scale
    becomes ``max(old or 0, absmax of its incoming rows / qmax)``, and its
    resident codes are decoded at the old scale and re-encoded at the new
    one (a lossless identity when the scale did not grow) before the new
    rows are written.  Every operand of the rescale is gathered before any
    write, and rows that share a block all use the block's final scale, so
    duplicate block rows write identical content.
    """
    qmax = policy.qmax
    wb, wo = write_blocks.long(), write_offsets.long()
    x32 = x.float()
    # a true division, as the reference's: PyTorch on the card multiplies by
    # the reciprocal when the divisor is a Python number, which can move the
    # scale by an ulp and with it the codes
    s_req = x32.abs().amax(dim=-1) / torch.full((), qmax, device=x.device)  # (N, Hkv)
    # a scatter-max, not a boolean-mask index, so the card never syncs here
    fresh = torch.zeros(scales.shape[0], dtype=torch.int32, device=scales.device
                        ).scatter_reduce(0, wb, (wo == 0).int(), "amax")
    s_pool0 = torch.where(fresh[:, None] > 0, torch.zeros_like(scales), scales)
    new_scales = s_pool0.scatter_reduce(0, wb[:, None].expand_as(s_req), s_req, "amax")

    old = codes_pool[wb]                                        # (N, Hkv, bs, D)
    vals = policy.decode(old) * s_pool0[wb][..., None, None]
    s_new_b = new_scales[wb].clamp_min(_TINY)                  # (N, Hkv)
    codes_pool[wb] = policy.encode(vals / s_new_b[..., None, None])
    codes_pool[wb, :, wo] = policy.encode(x32 / s_new_b[..., None])
    scales.copy_(new_scales)
    return codes_pool, scales


# -- property checker --------------------------------------------------------

def check_quant_roundtrip(x, policy: KVQuantPolicy, *, atol: float = 1e-6):
    """Assert that one-block absmax quantize/dequantize error stays within
    :meth:`KVQuantPolicy.error_bound` elementwise (+ ``atol``).  Returns
    ``(dequant, scale, max_err)``."""
    x32 = torch.as_tensor(x, dtype=torch.float32)
    scale = float(x32.abs().max()) / policy.qmax if x32.numel() else 0.0
    s = max(scale, _TINY)
    deq = policy.decode(policy.encode(x32 / s)) * s
    max_err = float((deq - x32).abs().max()) if x32.numel() else 0.0
    bound = float(policy.error_bound(scale)) + atol
    if max_err > bound:
        raise AssertionError(f"{policy.name}: round-trip error {max_err} exceeds bound "
                             f"{bound} (scale={scale})")
    return deq, scale, max_err
