#!/usr/bin/env python3
"""Where the routing flips of chip_smoke.py phase 17 (b) come from: the
first MoE layer's top-1 routes of m6-base on (b)'s first batch (16 x 256,
the seed's weights, bf16, ``--moe-impl alltoall``) on one device, under
changes of arithmetic that each redo one part of the (data 2, model 2)
mesh's forward, counted against the plain single-device forward:

- ``again``: the same forward once more (0 unless the card is not
  deterministic);
- ``data split``: the batch as two forwards of 8 rows, a data rank's rows
  (every matmul sees half the rows);
- ``heads split``: q, k and v each as two matmuls over half the columns,
  a model rank's heads;
- ``wo row-parallel bf16``: the attention's output projection as two
  partial products over half the heads each, each rounded to bf16, summed
  in bf16: what a rank's ``wo`` block and the all_reduce over "model"
  compute;
- ``wo row-parallel f32``: the same two partial products in f32, summed
  in f32 and rounded to bf16 once;
- ``mesh``: data split, heads split and ``wo`` row-parallel in bf16
  together.

Only the first MoE layer counts: its router sees the embedding and one
attention block, while a later layer also sees the earlier layers' flips.

    python3 routing_flips.py [--device cuda|cpu] [--smoke]

Prints the card line and, last, one JSON object {variant: {"flips": n,
"max_margin": the largest router-logit margin of a flipped token,
"tokens": n}}.  ``--smoke`` runs m6-base's smoke config on 8 x 32 (a CPU
check of the script)."""
import argparse
import json
import sys
from contextlib import ExitStack, contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

VARIANTS = ("again", "data split", "heads split", "wo row-parallel bf16",
            "wo row-parallel f32", "mesh")


@contextmanager
def split_attention(heads: bool, wo: str):
    """The attention's projections as a (model 2) mesh computes them:
    ``heads``: q, k and v as two halves of their columns; ``wo`` ("bf16",
    "f32" or ""): the output projection as two partial products over half
    its rows, rounded to bf16 and summed in bf16, or summed in f32 and
    rounded once."""
    from unittest import mock

    import torch

    from repro_torch.models import attention

    real_dense, real_qkv = attention.dense_apply, attention._project_qkv
    at = {"qkv": False, "wo": False, "split": 0}

    def dense(params, x, cfg):
        k = params["kernel"].to(cfg.activation_dtype)
        if at["qkv"] and heads:
            n = k.shape[-1] // 2
            y = torch.cat([x @ k[:, :n], x @ k[:, n:]], dim=-1)
        elif at["wo"] and wo:
            at["wo"] = False
            h = k.shape[0] // 2
            if wo == "bf16":
                y = x[..., :h] @ k[:h] + x[..., h:] @ k[h:]
            else:
                y = (x[..., :h].float() @ k[:h].float()
                     + x[..., h:].float() @ k[h:].float()).to(x.dtype)
        else:
            return real_dense(params, x, cfg)
        at["split"] += 1
        if "bias" in params:
            y = y + params["bias"].to(y.dtype)
        return y

    def qkv(*args, **kw):
        at["qkv"] = True
        try:
            return real_qkv(*args, **kw)
        finally:
            at["qkv"], at["wo"] = False, True     # the next projection is wo

    with mock.patch.object(attention, "dense_apply", dense), \
            mock.patch.object(attention, "_project_qkv", qkv):
        yield
    if not at["split"]:
        raise AssertionError("split_attention: no projection of the forward was split")


def first_routes(torch, cs, cfg, params, batch, rows_split: bool):
    """The first routing call's (routes, margins) of the forward, over the
    whole batch or as two halves of its rows."""
    from repro_torch.train.trainer import make_loss_fn

    loss_fn = make_loss_fn(cfg)
    parts = ([{k: v[:len(v) // 2] for k, v in batch.items()},
              {k: v[len(v) // 2:] for k, v in batch.items()}] if rows_split else [batch])
    routes, margins = [], []
    for part in parts:
        store = []
        with torch.no_grad(), cs.recorded_routing(store):
            loss_fn(params, part)
        routes.append(store[0][0])
        margins.append(store[0][1])
    return torch.cat(routes), torch.cat(margins)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    from repro_torch.launch.train import build_parser, device_batch, setup

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("routing_flips: no CUDA device")
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    base = (["--arch", "m6-base", "--smoke", "--batch", "8", "--seq", "32"] if args.smoke
            else list(cs.MESH_TRAIN_ARGS))
    with cs.cut_depth(1):
        cfg, _, _, state, pipeline = setup(build_parser().parse_args(
            base + ["--moe-impl", "alltoall", "--device", args.device]))
    batch = device_batch(pipeline.batch_at(0), args.device)
    params = state.params
    plain, margin = first_routes(torch, cs, cfg, params, batch, False)
    out = {}
    for name in VARIANTS:
        heads = name in ("heads split", "mesh")
        wo = {"wo row-parallel bf16": "bf16", "wo row-parallel f32": "f32",
              "mesh": "bf16"}.get(name, "")
        with ExitStack() as stack:
            if heads or wo:
                stack.enter_context(split_attention(heads, wo))
            got, _ = first_routes(torch, cs, cfg, params, batch,
                                  name in ("data split", "mesh"))
        flipped = (got != plain).nonzero().flatten()
        out[name] = dict(flips=int(flipped.numel()), tokens=int(plain.numel()),
                         max_margin=float(margin[flipped].max()) if flipped.numel() else None)
        print(f"{name}: {out[name]['flips']} of {out[name]['tokens']} tokens flipped, largest "
              f"margin {out[name]['max_margin']}", flush=True)
    if args.device == "cuda":
        print(cs.card_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
