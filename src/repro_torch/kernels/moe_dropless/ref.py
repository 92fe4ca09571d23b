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
0; live blocks come out as without it.  ``live_blocks`` is that rule.

The dropless combine (the reference's ``.at[gi, tok].add(out * gate)``):
``index_row_map`` / ``slot_row_map`` invert the ragged view's
``sort_order`` (its valid ids are unique) into a (G, T, K) map from each
token's choice to its ragged row, -1 where the choice is not routed, with
a ``scatter_`` and a gather on the device (no sort, no read to the host).
``ragged_combine_ref`` is the gather-sum over that map, the yardstick of
``csrc/ragged_combine.cu``; ``ragged_combine_grads`` its backward."""
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


def _inverted(sort_order: torch.Tensor, n: int) -> torch.Tensor:
    """(G, n) int32: the ragged row that holds id i of ``sort_order`` (G,
    R), -1 for an id no row holds.  The valid ids are unique, so one
    ``scatter_`` inverts the view; -1 rows are parked on a column past
    ``n`` and cut away."""
    G, R = sort_order.shape
    ids = torch.where(sort_order >= 0, sort_order, torch.full_like(sort_order, n)).long()
    rows = torch.arange(R, dtype=torch.int32, device=sort_order.device).expand(G, R)
    inv = torch.full((G, n + 1), -1, dtype=torch.int32, device=sort_order.device)
    return inv.scatter_(1, ids, rows)[:, :n]


def index_row_map(sort_order: torch.Tensor, T: int, K: int) -> torch.Tensor:
    """The combine's row map of an index view, whose ids are ``t * K + k``:
    (G, T, K) int32, the ragged row of token t's choice k or -1."""
    return _inverted(sort_order, T * K).reshape(sort_order.shape[0], T, K)


def slot_row_map(sort_order: torch.Tensor, expert_index: torch.Tensor,
                 slot_index: torch.Tensor, valid: torch.Tensor, slots: int,
                 num_experts: int) -> torch.Tensor:
    """The row map of a slot-major view, whose ids are ``e * slots + c``:
    a token's choices are looked up through the plan's index view
    (``expert_index``, ``slot_index``, ``valid``: (G, T, K)); (G, T, K)
    int32, -1 where a choice is not valid.  Invalid choices carry slot
    ``capacity`` >= ``slots``: the clamps only keep their gather in
    range."""
    G, T, K = expert_index.shape
    inv = _inverted(sort_order, num_experts * slots)
    e = torch.clamp(expert_index, 0, num_experts - 1).long()
    c = torch.clamp(slot_index, 0, slots - 1).long()
    rows = inv.gather(1, (e * slots + c).reshape(G, T * K)).reshape(G, T, K)
    return torch.where(valid, rows, torch.full_like(rows, -1))


def _gathered(out: torch.Tensor, gate: torch.Tensor, rows: torch.Tensor):
    """The (G, T, K, M) rows and (G, T, K) gates the map names (row 0 where
    it names none) and the (G, T, K) mask of the routed choices."""
    G, R, M = out.shape
    _, T, K = rows.shape
    idx = torch.clamp(rows, min=0).long().reshape(G, T * K)
    o = out.gather(1, idx[..., None].expand(G, T * K, M)).reshape(G, T, K, M)
    return o, gate.gather(1, idx).reshape(G, T, K), rows >= 0


def ragged_combine_ref(out: torch.Tensor, gate: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """y[g, t] = sum over k of round(out[g, r] * gate[g, r]) with r =
    rows[g, t, k] >= 0: each term in out's dtype (out times the gate cast
    to it, as the dispatcher's ``vals``), the terms summed in f32 in the
    order k = 0..K-1 and rounded once.  A token with no routed choice comes
    out 0; rows the map does not name (padding, dead blocks) are never
    read, so a NaN there does not reach y.  out: (G, R, M); gate: (G, R)
    f32; rows: (G, T, K).  Returns (G, T, M) in out's dtype."""
    o, g, routed = _gathered(out, gate, rows)
    terms = o * g.to(out.dtype)[..., None]
    terms = torch.where(routed[..., None], terms, torch.zeros_like(terms)).float()
    y = torch.zeros_like(terms[:, :, 0])
    for k in range(terms.shape[2]):
        y = y + terms[:, :, k]
    return y.to(out.dtype)


def row_tokens(rows: torch.Tensor, R: int) -> torch.Tensor:
    """(G, R) int64: the token each ragged row is combined into, -1 for a
    row the map ``rows`` (G, T, K) does not name."""
    G, T, K = rows.shape
    dest = torch.where(rows >= 0, rows, torch.full_like(rows, R)).long().reshape(G, T * K)
    t = torch.arange(T, device=rows.device)[None, :, None].expand(G, T, K).reshape(G, T * K)
    tok = torch.full((G, R + 1), -1, dtype=torch.long, device=rows.device)
    return tok.scatter_(1, dest, t)[:, :R]


def ragged_combine_grads(out: torch.Tensor, gate: torch.Tensor, rows: torch.Tensor,
                         grad: torch.Tensor):
    """The combine's backward: d out[r] = gate[r] * grad[token(r)] and d
    gate[r] = <out[r], grad[token(r)]>, with the dispatcher's roundings
    (the product in out's dtype; the gate's sum over M in it, then f32);
    0 on rows the map does not name.  grad: (G, T, M).  Returns (d out (G,
    R, M), d gate (G, R) f32)."""
    G, R, M = out.shape
    tok = row_tokens(rows, R)
    routed = (tok >= 0)[..., None]
    gy = grad.gather(1, torch.clamp(tok, min=0)[..., None].expand(G, R, M))
    d_out = torch.where(routed, gy * gate.to(out.dtype)[..., None], torch.zeros_like(gy))
    d_gate = torch.where(routed, gy * out, torch.zeros_like(gy)).sum(-1).float()
    return d_out, d_gate
