"""Helpers shared by the kernel wrappers: the activation codes of the
grouped-FFN sources, the grouped FFN's and flash attention's routes by
shape and type, and the backward of a kernel without a backward kernel."""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def act_code(activation: str, gated: bool) -> int:
    """The C sources' activation code, with the reference's mapping: gated
    -> silu for "swiglu", else gelu; ungated -> gelu for "gelu", else relu."""
    if gated:
        return 3 if activation == "swiglu" else 4
    return 1 if activation == "gelu" else 2


# token-tile widths (wgmma N) that kernels/csrc/grouped_ffn_sm90.cuh instantiates
TC_TILE_ROWS = (8, 16, 32, 48, 64, 96, 128, 192)


def tensor_core_route(dtype: torch.dtype, M: int, I: int) -> bool:
    """Whether the grouped FFN (``moe_ffn``, ``ragged_ffn``) takes the
    tensor-core device code (``grouped_ffn_sm90.cuh``): bf16, and both
    widths multiples of 8 so that every row is 16-byte aligned for TMA.
    f32 and other widths take the CUDA-core code (``grouped_ffn.cuh``)."""
    return dtype == torch.bfloat16 and M % 8 == 0 and I % 8 == 0


def flash_tensor_core_route(dtype: torch.dtype, D: int) -> bool:
    """Whether flash attention takes the tensor-core device code
    (``flash_attention_sm90.cuh``, entry point ``flash_attention_tc``):
    bf16 with a head width of one or two 64-column TMA boxes.  f32, and
    D in (16, 32), take the CUDA-core kernel."""
    return dtype == torch.bfloat16 and D in (64, 128)


def tile_rows(rows: int, gated: bool) -> Tuple[int, int]:
    """(n, tiles): a group of ``rows`` token rows runs as ``tiles`` wgmma
    tiles of n columns, n the narrowest width in ``TC_TILE_ROWS`` that
    covers an even share; at most 192 columns, 128 gated (a consumer thread
    holds N/2 f32 accumulator registers for the up product and, gated, as
    many for the gate product)."""
    cap = 128 if gated else 192
    tiles = max(1, -(-rows // cap))
    share = -(-rows // tiles)
    return next(n for n in TC_TILE_ROWS if n >= share), tiles


def ref_vjp(ref: Callable, inputs: Sequence, needs_grad: Sequence[bool],
            grad: torch.Tensor) -> tuple:
    """Gradients of ``ref(*inputs)`` against ``grad`` for the inputs flagged
    in ``needs_grad`` (None for the others): autograd through the plain
    version, as the reference's ``custom_vjp`` backward differentiates its
    ``ref.py``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if isinstance(t, torch.Tensor) else t
                  for t, n in zip(inputs, needs_grad)]
        out = ref(*leaves)
        wrt = [t for t, n in zip(leaves, needs_grad) if n]
        grads = iter(torch.autograd.grad(out, wrt, grad) if wrt else ())
    return tuple(next(grads) if n else None for n in needs_grad)
