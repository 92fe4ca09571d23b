#!/usr/bin/env python3
"""Device times of the three decode attention kernels at chip_smoke.py's
shapes, to compare two checkouts on one card in one call:

    python3 decode_timing.py [CHECKOUT ...]     # default: this checkout

Each CHECKOUT (a directory holding chip_smoke.py and src/, e.g. an older
commit unpacked with ``git archive`` under build/) is timed in a process
of its own with its own code, kernels built under its own build/.  Order
them in turns (parent, change, change, parent) to see the spread.  Shapes:
the dense kernel at the static trace's cache (B 8, T 111, every row at
70) and at the decode step (8 rows of 9-112 positions in a 256-position
cache); the paged and int8 kernels at the decode step.  Prints the card
line and one JSON line a checkout: {"checkout", name: {"device_ms",
"ms", "bound_ms", "plan"}}.  Needs a CUDA card."""
import json
import subprocess
import sys
from pathlib import Path

DECODE_LENS = [21, 56, 112, 9, 74, 33, 98, 47]   # chip_smoke.py phase 4's decode step


def time_one(checkout: Path) -> dict:
    sys.path[:0] = [str(checkout / "src"), str(checkout)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        raise SystemExit("decode_timing: no CUDA device")
    build.build(["paged_decode_attention", "quantized_paged_decode_attention",
                 "decode_attention"])
    T, length = cs.static_shapes()["trace"]
    runs = {"decode_attention static": cs.time_dense(torch, [length] * 8, 164, T=T),
            "decode_attention decode": cs.time_dense(torch, DECODE_LENS, 110),
            "paged_decode_attention decode": cs.time_attention(torch, DECODE_LENS, 70),
            "quantized_paged_decode_attention decode": cs.time_quantized(torch, DECODE_LENS,
                                                                         90)}
    out = {"checkout": str(checkout)}
    for name, r in runs.items():
        out[name] = {k: r.get(k) for k in ("device_ms", "ms", "bound_ms", "plan")}
    return out


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--one":
        print(json.dumps(time_one(Path(sys.argv[2]).resolve()), default=list), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no card", flush=True)
    for checkout in sys.argv[1:] or [str(Path(__file__).resolve().parent)]:
        done = subprocess.run([sys.executable, __file__, "--one", checkout],
                              capture_output=True, text=True)
        if done.returncode:
            print(done.stderr[-4000:], file=sys.stderr)
            return done.returncode
        print(done.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
