#!/usr/bin/env python3
"""The grouped FFNs' device times at the port's shapes, in one checkout:
the ragged FFN at the serving steps (decode, mixed), the static prefill,
expert choice, the model drafter's two groups, granite's gated top-8
decode, a mesh rank's received buffers (decode, mixed) and a training
rank's, and ``moe_ffn`` at X = 45 and 180, each beside its bound and
``grouped_mm`` / ``torch.bmm``, timed by ``chip_smoke.py``'s phase 4
functions of that checkout (``time_ffn``, ``time_mesh_ffn``,
``time_moe_ffn``).

    python3 ragged_timing.py [CHECKOUT]

CHECKOUT (default: this file's directory) is a tree of this repository,
say a parent commit unpacked with ``git archive`` under ``build/``; its
kernels build there.  To compare two commits on one card, run them in
turns in one call (parent, change, change, parent).  Needs a CUDA card.
Prints a ``RESULT`` line a shape, then the card line."""
import sys
import time
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parent).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("ragged_timing: no CUDA device")
    t0 = time.perf_counter()
    build.build(["ragged_ffn", "moe_ffn"])
    print(f"{root}: built in {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"decode": cs.time_ffn(torch, 8, seed=80, weights=None),
           "mixed": cs.time_ffn(torch, 40, seed=80, weights=None),
           "static prefill": cs.time_ffn(torch, 384, seed=162, weights=None),
           "expert choice": cs.time_ffn(torch, 1152, seed=163, weights=None, capacity=45),
           "drafter": cs.time_ffn(torch, 1024, seed=150, weights=None, groups=2),
           "granite decode": cs.time_ffn(torch, 8, seed=790, weights=None,
                                         shape=(40, 1536, 512, "swiglu", 8))}
    for j, (label, groups) in enumerate(cs.MESH_FFN_GROUPS.items()):
        out[f"mesh {label}"] = cs.time_mesh_ffn(torch, groups, 1660 + j)
    out["mesh train rank"] = cs.time_mesh_ffn(torch, 1, 1730, tokens=cs.MESH_TRAIN_GROUP,
                                              bx=cs.MESH_TRAIN_BX)
    out["moe45"] = cs.time_moe_ffn(torch, 45, seed=100)
    out["moe180"] = cs.time_moe_ffn(torch, 180, seed=101)
    for label, r in out.items():
        print(f"RESULT {root.name} {label} {cs.timing_line(r)}", flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
