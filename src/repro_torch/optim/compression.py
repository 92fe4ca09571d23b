"""Gradient compression (``repro.optim.compression``), over the flat
gradient dict.  ``TrainConfig.grad_compression``:

* ``bf16``: the gradients cast to bfloat16, the reference's analogue of
  the paper's FP16 communication (Table 5);
* ``int8``: per-tensor symmetric int8 quantisation with error feedback:
  each step quantises gradient + residual and carries the f32 residual
  (``TrainState.error_feedback``) to the next.

The reference's ``compressed_psum`` (int8 codes all-gathered inside a
``shard_map``) is a multi-device collective and is not ported.

Rounding is the reference's: ``torch.round`` and ``jnp.round`` both round
half to even, the codes are clipped to +-127 and the scale floored at
1e-12 / 127.  The divisions by 127 and by the scale divide by tensors
(PyTorch on the card multiplies by the reciprocal of a Python number),
so the codes are the reference's on the same inputs.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, 0-dim f32 scale): scale = max(|x|, 1e-12) / 127."""
    x32 = x.float()
    qmax = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    scale = x32.abs().max().clamp_min(1e-12) / qmax
    q = torch.round(x32 / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: Dict[str, torch.Tensor], mode: str,
                   error_feedback: Optional[Dict[str, torch.Tensor]] = None):
    """Lossy-compress the gradients; returns (compressed grads, new error
    feedback).  ``int8`` starts from a zero residual when none is given."""
    if mode == "none":
        return grads, error_feedback
    if mode == "bf16":
        return {k: g.to(torch.bfloat16) for k, g in grads.items()}, error_feedback
    if mode == "int8":
        if error_feedback is None:
            error_feedback = {k: torch.zeros_like(g, dtype=torch.float32)
                              for k, g in grads.items()}
        out, ef = {}, {}
        for k, g in grads.items():
            target = g.float() + error_feedback[k]
            deq = dequantize_int8(*quantize_int8(target))
            out[k] = deq.to(g.dtype)
            ef[k] = target - deq
        return out, ef
    raise ValueError(f"unknown compression mode {mode!r}")
