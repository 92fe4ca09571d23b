#!/usr/bin/env python3
"""Where the ragged FFN's tensor-core route parts from its split-h plain
version (``ragged_ffn_split_ref``, h as bf16 hi + lo, f32 sums): at
chip_smoke.py phase 17 (b)'s one-device shape (4 groups of 1024 tokens
routed top-1 over 32 experts, bx 32: 8064 rows) and at the model
drafter's (2 groups: 4032 rows), for a few seeds, the outputs beyond
phase 3's split-h tolerance (atol SPLIT_ATOL + rtol SPLIT_RTOL), each with
the kernel's value, the split-h plain version's in bf16 and before its
rounding, the f32 plain version's and an f64 sum's.

    python3 ffn_accuracy.py

Needs a CUDA card.  Prints a line a case and a line an output beyond the
tolerance, then the card line."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

CASES = ((1711, 4), (1712, 4), (1713, 4), (150, 2), (1714, 2))     # (seed, groups)


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.moe_dropless import ops as rffn
    from repro_torch.kernels.moe_dropless.ref import ragged_ffn_split_ref
    from repro_torch.kernels.moe_ffn.ref import _act, split_h

    if not torch.cuda.is_available():
        raise SystemExit("ffn_accuracy: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(["ragged_ffn"])
    for seed, groups in CASES:
        xs, be, w, rag, bx = cs.ffn_case(cs.MESH_TRAIN_GROUP, 32, 1024, 4096, seed=seed,
                                         groups=groups, bx=cs.MESH_TRAIN_BX)
        out = rffn.ragged_ffn(xs, be, *w, "gelu", block_x=bx)
        want = ragged_ffn_split_ref(xs, be, *w, "gelu")
        err = (out.float() - want.float()).abs()
        beyond = (err > cs.SPLIT_ATOL + cs.SPLIT_RTOL * want.float().abs()).nonzero().tolist()
        print(f"seed {seed}, {groups} groups, {xs.shape[0]} rows: |y| median "
              f"{float(want.float().abs().median()):.4g}, max {float(want.float().abs().max()):.4g}; "
              f"{len(beyond)} of {out.numel()} outputs beyond the split-h tolerance", flush=True)
        for r, c in beyond:
            e = int(be[r // bx])
            h = _act(xs[r].float() @ w[0][e].float(), None, "gelu")
            h64 = _act(xs[r].double() @ w[0][e].double(), None, "gelu")
            print(f"  row {r} col {c} expert {e}: kernel {float(out[r, c]):.6g}, split-h "
                  f"{float(want[r, c]):.6g} (f32 {float(split_h(h) @ w[2][e][:, c].float()):.6g}), "
                  f"f32 plain {float(h @ w[2][e][:, c].float()):.6g}, f64 "
                  f"{float(h64 @ w[2][e][:, c].double()):.6g}", flush=True)
        del xs, be, w, rag, out, want, err
        torch.cuda.empty_cache()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
