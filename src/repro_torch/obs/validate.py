"""Schema validators for the observability output files (a copy of
``repro.obs.validate``, pure Python).

Shared by the tests and the command line (``python -m
repro_torch.obs.validate trace.json metrics.jsonl [--require name ...]``):
a trace must be a well-formed Chrome-trace JSON whose async spans balance,
and a metrics file must be JSONL whose rows carry a flat ``metrics``
mapping of finite numbers.  Both raise ``ValueError`` with a specific message on
the first violation and return a small summary dict on success.
"""
from __future__ import annotations

import json
import math
import sys
from typing import Dict, Sequence

_PHASES = {"X", "b", "e", "i", "M", "C"}


def validate_chrome_trace(path: str) -> Dict[str, int]:
    """Perfetto-loadability checks: top-level ``traceEvents`` list;
    every event has name/ph/ts; ``X`` events carry a non-negative
    ``dur``; ``b``/``e`` events carry an id and balance exactly (never
    more ends than begins, none left open) per ``(cat, id)``."""
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError(f"{path}: not a Chrome trace "
                         "(missing 'traceEvents' list)")
    depth: Dict[tuple, int] = {}
    counts = {"X": 0, "b": 0, "e": 0, "i": 0}
    for i, ev in enumerate(doc["traceEvents"]):
        for field in ("name", "ph", "ts"):
            if field not in ev:
                raise ValueError(f"{path}: event {i} missing {field!r}")
        ph = ev["ph"]
        if ph not in _PHASES:
            raise ValueError(f"{path}: event {i} has unknown ph {ph!r}")
        if not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"{path}: event {i} ts is not a number")
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"{path}: X event {i} ({ev['name']}) "
                                 "needs a non-negative dur")
        if ph in ("b", "e"):
            if "id" not in ev:
                raise ValueError(f"{path}: async event {i} missing id")
            key = (ev.get("cat", ""), ev["id"])
            depth[key] = depth.get(key, 0) + (1 if ph == "b" else -1)
            if depth[key] < 0:
                raise ValueError(
                    f"{path}: async end without begin for {key}")
        if ph in counts:
            counts[ph] += 1
    open_spans = {k: d for k, d in depth.items() if d != 0}
    if open_spans:
        raise ValueError(f"{path}: unclosed async spans: "
                         f"{sorted(open_spans)[:5]}")
    counts["events"] = len(doc["traceEvents"])
    return counts


def validate_metrics_jsonl(path: str,
                           require: Sequence[str] = ()) -> Dict[str, int]:
    """Every line parses as a JSON object with a ``metrics`` dict of
    string → finite number; the *last* row must contain every metric
    name in ``require`` (matched as an exact series or as a name prefix
    before ``{``, so ``kv_blocks`` matches ``kv_blocks{shard=0,...}``)."""
    rows = []
    with open(path) as fh:
        for ln, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{ln}: not JSON ({e})") from None
            if not isinstance(row, dict) or not isinstance(
                    row.get("metrics"), dict):
                raise ValueError(f"{path}:{ln}: row needs a 'metrics' dict")
            for k, v in row["metrics"].items():
                if not isinstance(k, str):
                    raise ValueError(f"{path}:{ln}: non-string metric key")
                if not isinstance(v, (int, float)) or (
                        isinstance(v, float) and not math.isfinite(v)):
                    raise ValueError(
                        f"{path}:{ln}: metric {k!r} is not a finite number "
                        f"({v!r})")
            rows.append(row)
    if not rows:
        raise ValueError(f"{path}: no metric rows")
    last = rows[-1]["metrics"]
    for name in require:
        if name in last:
            continue
        if any(k.split("{", 1)[0] == name for k in last):
            continue
        raise ValueError(f"{path}: last row missing required metric "
                         f"{name!r}")
    return {"rows": len(rows), "series": len(last)}


def _main(argv: Sequence[str]) -> int:
    argv = list(argv)
    require: Sequence[str] = ()
    if "--require" in argv:                 # names after the flag, for .jsonl
        i = argv.index("--require")
        argv, require = argv[:i], tuple(argv[i + 1:])
    ok = True
    for path in argv:
        try:
            if path.endswith(".jsonl"):
                info = validate_metrics_jsonl(path, require=require)
            else:
                info = validate_chrome_trace(path)
            print(f"{path}: OK {info}")
        except ValueError as e:
            print(f"FAIL: {e}")
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
