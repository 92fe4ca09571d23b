"""Mamba2 / SSD blocks (arXiv:2405.21060; ``repro.models.mamba2``): the
chunked scan for training and the parallel forward, and an O(1) recurrent
step for decode.

Follows the ``ssd_minimal_discrete`` reference: per-head scalar decay
``a = -exp(A_log)``, discretisation ``adt = exp(dt * a)``, state
``h[B, H, P, N]`` (P = head dim, N = d_state), B/C shared across heads
(n_groups = 1).  The scan's products are XLA einsums in the reference,
outside any Pallas kernel, so their port is plain PyTorch.

Two of the reference's behaviours are kept as they are:

* with a state, the block reads only token 0 of its input and broadcasts
  ``y + x * D`` over S, so S > 1 with a state would be silently wrong;
  the port raises there (the engines only ever feed S = 1; ROADMAP
  queue 3);
* the decode state's conv tail is f32, and concatenating it promotes the
  decode conv, x / B / C and what follows to f32 under bf16 activations,
  where the parallel form stays in the activation dtype up to the scan
  (``models.xlstm._causal_conv``).

On a mesh whose rules shard ``"ssm_inner"`` over the model axis (zamba's
tensor parallelism), a rank holds its block of the heads' channels:
``in_z`` / ``in_x`` are column-parallel (their input enters through
``collectives.copy_to``), ``head_norm`` its heads' scales, ``out_proj``
row-parallel with one ``all_reduce``.  ``in_B``, ``in_C``, ``in_dt`` and
the per-head ``A_log``, ``dt_bias`` and ``D`` are whole on every rank; a
rank reads all of B and C and its heads' columns of the rest, each
through ``copy_to``, whose backward sums the ranks' parts of its
gradient.  The conv's leaves are whole too (``sharding.HELD_WHOLE``): a
rank convolves its x channels and the B and C channels with their columns.
The SSD scan and the decode state (:class:`Mamba2State`) hold the rank's
heads and conv channels.  Where a rank's block of the channels is not
whole heads, the block gathers its channel-sharded leaves and every rank
computes every head (its state too).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import tensor_parallel
from repro_torch.models import layers as L
from repro_torch.models.xlstm import _causal_conv
from repro_torch.nn.spec import ParamShape, _norm


class Mamba2State(NamedTuple):
    h: torch.Tensor     # (B, H, P, N) SSM state
    conv: torch.Tensor  # (B, W-1, conv_dim) conv tail


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or max(d_inner // 64, 1)
    return d_inner, H, d_inner // H, cfg.ssm_state


def _heads_split(cfg: ModelConfig):
    """(process group, ranks, rank) of the model axis over which the active
    rules shard the heads' channels in whole heads, or None (no rules, the
    channels unsharded, or a rank's block of them not whole heads: the
    block then computes every head, :func:`_gathered_channels`)."""
    tp = tensor_parallel("ssm_inner")
    return tp if tp is not None and _dims(cfg)[1] % tp[1] == 0 else None


# the leaves the rules shard by the heads' channels, and that dim
_CHANNEL_DIMS = {"in_z": -1, "in_x": -1, "head_norm": -1, "out_proj": -2}


def _gathered_channels(params, d_inner: int):
    """The block's channel-sharded leaves whole where the active rules shard
    them and a rank's block is not whole heads: all-gathered over the model
    axis, so that every rank computes every head, as the reference's GSPMD
    computes the block (``grad="slice"``: the gather's backward keeps a
    rank its own block's gradient)."""
    tp = tensor_parallel("ssm_inner")
    if tp is None or params["in_x"].shape[-1] == d_inner:
        return params
    return {**params, **{k: collectives.all_gather(params[k], tp[0], dim=d, grad="slice")
                         for k, d in _CHANNEL_DIMS.items()}}


def _rank_leaves(params, cfg: ModelConfig, group, n: int, r: int):
    """The block's params as rank ``r`` of ``n`` uses them: the whole
    leaves through ``copy_to``, cut to the rank's heads (``in_dt``,
    ``A_log``, ``dt_bias``, ``D``) or its conv channels (its x channels, then
    B and C); the sharded leaves as they are."""
    d_inner, H, _, _ = _dims(cfg)
    heads = slice(r * H // n, (r + 1) * H // n)
    lo, hi = r * d_inner // n, (r + 1) * d_inner // n
    out = dict(params)
    for k in ("in_B", "in_C"):
        out[k] = collectives.copy_to(params[k], group)
    out["in_dt"] = collectives.copy_to(params["in_dt"], group)[:, heads]
    for k in ("A_log", "dt_bias", "D"):
        out[k] = collectives.copy_to(params[k], group)[heads]
    for k in ("conv_w", "conv_b"):
        w = collectives.copy_to(params[k], group)
        out[k] = torch.cat([w[..., lo:hi], w[..., d_inner:]], dim=-1)
    return out


def mamba2_block_shapes(cfg: ModelConfig, wdt: str, lead: Tuple[int, ...] = ()):
    """One block's param shapes, key for key the reference's
    ``mamba2_block_specs``, each with ``lead`` dims in front (the layer
    stack).  Separate projections, as the reference has them; the conv
    bias and the per-head decay, step bias, skip and norm are f32 in both
    trees."""
    d = cfg.d_model
    d_inner, H, _, N = _dims(cfg)
    conv_dim = d_inner + 2 * N          # x, B and C go through the conv

    def w(*shape, axes, dtype=wdt, init="normal"):
        return ParamShape(lead + shape, dtype, init, ("layers",) * len(lead) + axes)

    inner, plain = ("embed", "ssm_inner"), ("embed", None)
    return {"ln": _norm(cfg, lead),
            "in_z": w(d, d_inner, axes=inner), "in_x": w(d, d_inner, axes=inner),
            "in_B": w(d, N, axes=plain), "in_C": w(d, N, axes=plain),
            "in_dt": w(d, H, axes=plain),
            "conv_w": w(cfg.ssm_conv_width, conv_dim, axes=(None, "ssm_inner")),
            "conv_b": w(conv_dim, axes=("ssm_inner",), dtype="float32", init="zeros"),
            "A_log": w(H, axes=(None,), dtype="float32", init="zeros"),
            "dt_bias": w(H, axes=(None,), dtype="float32", init="zeros"),
            "D": w(H, axes=(None,), dtype="float32", init="ones"),
            "head_norm": w(d_inner, axes=("ssm_inner",), dtype="float32", init="ones"),
            "out_proj": w(d_inner, d, axes=("ssm_inner", "embed"))}


def _segsum(logd: torch.Tensor) -> torch.Tensor:
    """logd (..., W) -> (..., W, W) lower-triangular cumulative sums,
    out[t, s] = sum_{s < r <= t} logd_r, -inf above the diagonal."""
    W = logd.shape[-1]
    cs = torch.cumsum(logd, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((W, W), dtype=torch.bool, device=logd.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A_log, Bmat, Cmat, chunk: int):
    """The chunked SSD scan.  x (B, S, H, P) f32; dt (B, S, H) after the
    softplus; Bmat / Cmat (B, S, N).  Chunks of W = min(chunk, S) steps, S
    zero-padded to a multiple of W (dt = 0 adds nothing and decays
    nothing).  Returns y (B, S, H, P) and the final state (B, H, P, N)."""
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    a = -torch.exp(A_log)                                           # (H,)
    W = min(chunk, S)
    pad = (W - S % W) % W
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    NC = x.shape[1] // W
    xc = x.reshape(Bsz, NC, W, H, P).permute(1, 0, 3, 2, 4)        # (NC, B, H, W, P)
    dtc = dt.reshape(Bsz, NC, W, H).permute(1, 0, 3, 2)            # (NC, B, H, W)
    Bc = Bmat.reshape(Bsz, NC, W, N).transpose(0, 1)               # (NC, B, W, N)
    Cc = Cmat.reshape(Bsz, NC, W, N).transpose(0, 1)
    causal = torch.ones((W, W), dtype=torch.bool, device=x.device).tril()
    h = x.new_zeros((Bsz, H, P, N))
    ys = []
    for c in range(NC):
        xb, dtb, Bb, Cb = xc[c], dtc[c], Bc[c], Cc[c]
        logd = dtb * a[None, :, None]                               # (B, H, W)
        Lmat = torch.exp(_segsum(logd))                             # (B, H, W, W)
        CB = torch.einsum("bsn,btn->bst", Cb, Bb)                   # (B, W, W)
        scores = torch.where(causal, CB[:, None] * Lmat, 0.0)
        xdt = xb * dtb[..., None]                                   # (B, H, W, P)
        y_diag = torch.einsum("bhst,bhtp->bhsp", scores, xdt)
        # inter-chunk: the contribution of the incoming state
        cum = torch.cumsum(logd, dim=-1)                            # (B, H, W)
        y_off = torch.einsum("bsn,bhpn->bhsp", Cb, h) * torch.exp(cum)[..., None]
        decay_to_end = torch.exp(cum[..., -1:] - cum)               # (B, H, W)
        h = torch.exp(cum[..., -1])[..., None, None] * h + torch.einsum(
            "bhs,bhsp,bsn->bhpn", decay_to_end * dtb, xb, Bb)
        ys.append(y_diag + y_off)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(Bsz, NC * W, H, P)
    return y[:, :S], h


def ssd_step(h, x, dt, A_log, Bvec, Cvec):
    """One token of the recurrence: h (B, H, P, N); x (B, H, P); dt (B, H);
    Bvec / Cvec (B, N).  Returns (y (B, H, P), h_new)."""
    a = -torch.exp(A_log)
    adt = torch.exp(dt * a[None, :])                                # (B, H)
    h_new = adt[..., None, None] * h + torch.einsum("bh,bhp,bn->bhpn", dt, x, Bvec)
    return torch.einsum("bhpn,bn->bhp", h_new, Cvec), h_new


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba2_block_apply(params, x, cfg: ModelConfig, *, state: Optional[Mamba2State] = None):
    """x (B, S, d) -> (x + block(x), new state).  Without a state: the
    chunked scan (chunk ``max(ssm_chunk, 16)``), new state None.  With one:
    a one-token decode step (S > 1 raises: the reference would read token
    0 alone and broadcast the result)."""
    Bsz, S, _ = x.shape
    d_inner, H, P, N = _dims(cfg)
    if state is not None and S != 1:
        raise ValueError(f"mamba2 decode takes one token a step, got S = {S} (the reference "
                         f"reads token 0 alone and broadcasts it)")
    dt_act = x.dtype
    h = L.norm_apply(params["ln"], x, cfg)
    tp = _heads_split(cfg)
    if tp is not None and params["in_x"].shape[-1] == d_inner:
        tp = None                           # a whole block
    if tp is None:
        params = _gathered_channels(params, d_inner)
    else:
        h = collectives.copy_to(h, tp[0])
        params = _rank_leaves(params, cfg, *tp)
        d_inner, H = d_inner // tp[1], H // tp[1]
    z = h @ params["in_z"].to(dt_act)
    xs = h @ params["in_x"].to(dt_act)
    Bm = h @ params["in_B"].to(dt_act)
    Cm = h @ params["in_C"].to(dt_act)
    dtm = h @ params["in_dt"].to(dt_act)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, new_tail = _causal_conv(conv_in, params["conv_w"].to(dt_act),
                                      state.conv if state is not None else None)
    conv_out = F.silu(conv_out + params["conv_b"].to(dt_act))
    xs, Bm, Cm = conv_out.split([d_inner, N, N], dim=-1)
    dt32 = _softplus(dtm.float() + params["dt_bias"])               # (B, S, H)
    x4 = xs.reshape(Bsz, S, H, P).float()
    if state is None:
        y, _ = ssd_chunked(x4, dt32, params["A_log"], Bm.float(), Cm.float(),
                           chunk=max(cfg.ssm_chunk, 16))
        new_state = None
    else:
        y1, h_new = ssd_step(state.h, x4[:, 0], dt32[:, 0], params["A_log"],
                             Bm[:, 0].float(), Cm[:, 0].float())
        y = y1[:, None]
        new_state = Mamba2State(h_new, new_tail.to(state.conv.dtype))
    y = y + x4 * params["D"][None, None, :, None]
    y = L.head_rmsnorm_apply(params["head_norm"].reshape(H, P), y, cfg.norm_eps)
    y = y.reshape(Bsz, S, d_inner).to(dt_act) * F.silu(z)
    out = y @ params["out_proj"].to(dt_act)
    if tp is not None:
        out = collectives.all_reduce(out, tp[0])
    return x + out, new_state


def mamba2_init_state(cfg: ModelConfig, batch: int, device=None, lead: Tuple[int, ...] = ()
                      ) -> Mamba2State:
    """Zeroed f32 state of one block, or of a stack with ``lead`` dims (a
    rank's heads and conv channels under rules that shard them)."""
    d_inner, H, P, N = _dims(cfg)
    tp = _heads_split(cfg)
    if tp is not None:
        d_inner, H = d_inner // tp[1], H // tp[1]
    conv_dim = d_inner + 2 * N
    return Mamba2State(
        torch.zeros(lead + (batch, H, P, N), dtype=torch.float32, device=device),
        torch.zeros(lead + (batch, cfg.ssm_conv_width - 1, conv_dim), dtype=torch.float32,
                    device=device))
