"""Plain PyTorch versions of the ragged grouped FFN.

``ragged_ffn_ref`` (``repro.kernels.moe_dropless.ref.ragged_ffn_ref``):
rows reshape to (NB, bx, M) blocks, each block gathers its expert's
weights and runs the dense FFN in f32.  The CPU path of the wrapper and
the yardstick the CUDA kernel is held to.

``ragged_ffn_split_ref``: the tensor-core route's numerics (h split into
bf16 hi + lo before the down product), for the card's checks only.

Both take the liveness the kernel takes (``live``: a tag per row, >= 0 on
a routed row): a block none of whose rows is routed is dead, its ``x`` is
not used (NaN there does not reach ``y``) and its rows come out exactly
0; live blocks come out as without it.  ``live_blocks`` is that rule."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_ffn.ref import moe_ffn_split_ref


def live_blocks(live: torch.Tensor, nb: int) -> torch.Tensor:
    """(nb,) bool: a block is live iff one of its rows has a tag >= 0
    (``live``: one tag per row, any shape of N elements)."""
    return (live.reshape(nb, -1) >= 0).any(dim=1)


def _blocks(x, block_expert, live):
    """x as (NB, bx, M) f32 blocks and the blocks' experts; with ``live``,
    dead blocks' rows zeroed and their experts 0 (neither is used), and the
    (NB, 1, 1) mask of the live blocks."""
    N, M = x.shape
    nb = block_expert.shape[0]
    xb = x.reshape(nb, N // nb, M).float()
    be = block_expert.long()
    if live is None:
        return xb, be, None
    keep = live_blocks(live, nb)
    return (torch.where(keep[:, None, None], xb, torch.zeros_like(xb)),
            torch.where(keep, be, torch.zeros_like(be)), keep[:, None, None])


def _dead_zero(y: torch.Tensor, keep) -> torch.Tensor:
    return y if keep is None else torch.where(keep, y, torch.zeros_like(y))


def ragged_ffn_ref(x: torch.Tensor, block_expert: torch.Tensor, w_up: torch.Tensor,
                   w_gate: Optional[torch.Tensor], w_down: torch.Tensor,
                   activation: str = "swiglu", live: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """x: (N, M) sorted rows; block_expert: (NB,) with N % NB == 0; live:
    None or one tag per row (N elements)."""
    N, M = x.shape
    xb, be, keep = _blocks(x, block_expert, live)
    h = torch.bmm(xb, w_up[be].float())
    if w_gate is not None:
        g = torch.bmm(xb, w_gate[be].float())
        h = (F.silu(g) if activation == "swiglu" else F.gelu(g, approximate="tanh")) * h
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        h = torch.clamp(h, min=0.0)
    return _dead_zero(torch.bmm(h, w_down[be].float()), keep).reshape(N, M).to(x.dtype)


def ragged_ffn_split_ref(x: torch.Tensor, block_expert: torch.Tensor, w_up: torch.Tensor,
                         w_gate: Optional[torch.Tensor], w_down: torch.Tensor,
                         activation: str = "swiglu", live: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """As :func:`ragged_ffn_ref`, with h kept as bf16 hi + lo before the
    down product (the tensor-core route's numerics)."""
    N, M = x.shape
    xb, be, keep = _blocks(x, block_expert, live)
    y = moe_ffn_split_ref(xb.to(x.dtype), w_up[be], None if w_gate is None else w_gate[be],
                          w_down[be], activation)
    return _dead_zero(y, keep).reshape(N, M)
