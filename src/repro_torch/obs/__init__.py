"""End-to-end observability (a copy of ``repro.obs``): span tracing, a
metrics registry, and the request-lifecycle bookkeeping that ties them
together.

:class:`Observability` is the bundle the serving stack threads around —
one per :class:`~repro_torch.serving.continuous.ContinuousEngine`, shared
with its :class:`~repro_torch.serving.scheduler.Scheduler` so both publish
into the same registry and trace.  The registry is always on (a few dict
updates per engine step); the tracer is opt-in (``tracing=True`` /
``--trace-out``).

Span taxonomy, metric names and labels: ``docs/observability.md`` (the
port publishes the subset its engine has).
"""
from __future__ import annotations

import json
from typing import Dict, Optional

from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import SpanTracer

__all__ = ["MetricsRegistry", "SpanTracer", "Observability"]


class Observability:
    def __init__(self, *, tracing: bool = False, trace_capacity: int = 65536,
                 metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = SpanTracer(capacity=trace_capacity, enabled=tracing)
        self._phase: Dict[int, str] = {}          # uid -> open phase span
        self._rows: list = []                     # buffered metrics JSONL rows
        self.metrics_every = 0                    # snapshot every N steps (0=off)

    # -- request lifecycle ---------------------------------------------------
    # One outer async span per request uid (cat="request") with nested
    # phase spans sharing the same id: queued -> prefill -> decode
    # [-> preempted -> prefill/decode ...] -> close.  The helpers keep
    # the open-phase table so callers only report transitions.

    def request_arrived(self, uid: int, *, prompt_len: int,
                        max_new_tokens: int) -> None:
        tr = self.tracer
        if tr.enabled:
            tr.begin("request", uid, "request", prompt_len=prompt_len,
                     max_new_tokens=max_new_tokens)
            tr.begin("request", uid, "queued")
        self._phase[uid] = "queued"

    def request_phase(self, uid: int, phase: str, **args) -> None:
        prev = self._phase.get(uid)
        if prev == phase:
            return
        tr = self.tracer
        if tr.enabled:
            if prev is not None:
                tr.end("request", uid, prev)
            tr.begin("request", uid, phase, **args)
        self._phase[uid] = phase

    def request_finished(self, uid: int) -> None:
        prev = self._phase.pop(uid, None)
        tr = self.tracer
        if tr.enabled:
            if prev is not None:
                tr.end("request", uid, prev)
            tr.end("request", uid, "request")

    # -- metrics JSONL sink --------------------------------------------------

    def metrics_row(self, **extra) -> None:
        """Buffer one registry snapshot as a JSONL row (``step=``,
        ``clock_ms=`` … go into the row head).  Rows are kept as dicts
        and serialized only at write time — snapshots sit on the
        serving hot path, JSON encoding does not need to."""
        row = dict(extra)
        row["metrics"] = self.metrics.snapshot()
        self._rows.append(row)

    def maybe_metrics_row(self, step: int) -> None:
        """Periodic snapshot hook the engine calls once per step."""
        if self.metrics_every and step > 0 and step % self.metrics_every == 0:
            self.metrics_row(step=step)

    def write_metrics_jsonl(self, path: str) -> None:
        """Write the buffered rows plus a final snapshot row."""
        rows = list(self._rows)
        final = {"final": True, "metrics": self.metrics.snapshot()}
        rows.append(final)
        with open(path, "w") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
