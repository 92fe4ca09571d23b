"""Gradient compression (``repro.optim.compression``), over the flat
gradient dict.  ``TrainConfig.grad_compression``:

* ``bf16``: the gradients cast to bfloat16, the reference's analogue of
  the paper's FP16 communication (Table 5);
* ``int8``: per-tensor symmetric int8 quantisation with error feedback:
  each step quantises gradient + residual and carries the f32 residual
  (``TrainState.error_feedback``) to the next.

On a mesh a gradient leaf is a rank's block, and the int8 scale is the
whole leaf's (``global_max``: the blocks' maxima all-reduced), as on the
reference's global arrays.  :func:`compressed_psum` is the reference's
explicit int8 collective over a process group (its ``shard_map`` axis):
each rank's codes and scale all-gathered, dequantised and summed.

Rounding is the reference's: ``torch.round`` and ``jnp.round`` both round
half to even, the codes are clipped to +-127 and the scale floored at
1e-12 / 127.  The divisions by 127 and by the scale divide by tensors
(PyTorch on the card multiplies by the reciprocal of a Python number),
so the codes are the reference's on the same inputs.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


def quantize_int8(x: torch.Tensor, global_max: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, 0-dim f32 scale): scale = max(|x|, 1e-12) / 127,
    the max over the whole leaf where ``x`` is a block of it
    (``global_max(block max)`` gives it)."""
    x32 = x.float()
    qmax = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    amax = x32.abs().max()
    if global_max is not None:
        amax = global_max(amax)
    scale = amax.clamp_min(1e-12) / qmax
    q = torch.round(x32 / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(x: torch.Tensor, group) -> torch.Tensor:
    """int8 all-gather and a local dequantised sum over ``group``: moves a
    quarter of an f32 all-reduce's bytes (the codes and one f32 scale a
    rank)."""
    from repro_torch.distributed import collectives

    q, scale = quantize_int8(x)
    qs = collectives.all_gather(q[None], group, dim=0)              # (n, ...)
    ss = collectives.all_gather(scale.reshape(1), group, dim=0)     # (n,)
    deq = qs.float() * ss.reshape((-1,) + (1,) * q.dim())
    return deq.sum(dim=0).to(x.dtype)


def compress_grads(grads: Dict[str, torch.Tensor], mode: str,
                   error_feedback: Optional[Dict[str, torch.Tensor]] = None,
                   global_max: Optional[Callable[[str], Callable]] = None):
    """Lossy-compress the gradients; returns (compressed grads, new error
    feedback).  ``int8`` starts from a zero residual when none is given;
    ``global_max(path)`` gives a block's :func:`quantize_int8` hook on a
    mesh (None: the leaves are whole)."""
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
            deq = dequantize_int8(*quantize_int8(
                target, None if global_max is None else global_max(k)))
            out[k] = deq.to(g.dtype)
            ef[k] = target - deq
        return out, ef
    raise ValueError(f"unknown compression mode {mode!r}")
