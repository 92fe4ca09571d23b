"""Low-overhead span tracer emitting Chrome-trace events.

The tracer is a preallocated ring buffer of event dicts over a
monotonic clock (``time.perf_counter_ns``).  Three event shapes cover
the serving taxonomy (see ``docs/observability.md``):

* **Complete spans** (``ph="X"``) — synchronous work with a duration:
  one per engine step (``engine_step``, args carry the step kind and
  live/padded row split).
* **Async spans** (``ph="b"``/``"e"``, paired by ``(cat, id)``) — the
  request lifecycle: an outer ``request`` span per uid with nested
  phase spans (``queued`` → ``prefill`` → ``decode`` →
  ``preempted`` → …) sharing the same async id, which is exactly how
  Perfetto renders nesting.
* **Instants** (``ph="i"``) — point events: ``preempt``, ``restore``,
  ``recompile``.

When disabled every emit path is a constant-time no-op (one attribute
check); ``span()`` returns a shared null context manager, so
instrumentation can stay in place unconditionally.  The ring buffer
never grows: past ``capacity`` events the oldest are overwritten and
``dropped_events`` counts the loss.

Export: :meth:`write_chrome_trace` writes a Perfetto-loadable
``{"traceEvents": [...]}`` JSON; :meth:`write_jsonl` writes the same
events one per line.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional


class _Span:
    """Context manager for one ``ph="X"`` complete span.  ``args`` is
    mutable until exit — fill in values discovered mid-span."""

    __slots__ = ("_tr", "name", "cat", "args", "_t0")

    def __init__(self, tr: "SpanTracer", name: str, cat: str, args: Dict):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        self._tr._emit({"name": self.name, "cat": self.cat, "ph": "X",
                        "ts": self._t0 / 1e3, "dur": (t1 - self._t0) / 1e3,
                        "pid": 0, "tid": 0, "args": self.args})


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NULL = _NullSpan()


class SpanTracer:
    def __init__(self, capacity: int = 65536, enabled: bool = False):
        if capacity < 1:
            raise ValueError("tracer capacity must be >= 1")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._ring: List[Optional[Dict]] = [None] * self.capacity
        self._n = 0                       # total events ever emitted

    # -- emit ---------------------------------------------------------------

    def _emit(self, ev: Dict) -> None:
        self._ring[self._n % self.capacity] = ev
        self._n += 1

    def _ts(self) -> float:
        return time.perf_counter_ns() / 1e3          # microseconds

    def span(self, name: str, cat: str = "engine", **args):
        """``with tracer.span("engine_step", kind="mixed") as sp: ...``
        — ``sp`` is None when tracing is disabled."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, cat, args)

    def begin(self, cat: str, id: object, name: str, **args) -> None:
        """Open an async span (``ph="b"``) under ``(cat, id)``."""
        if not self.enabled:
            return
        self._emit({"name": name, "cat": cat, "ph": "b", "id": str(id),
                    "ts": self._ts(), "pid": 0, "tid": 0, "args": args})

    def end(self, cat: str, id: object, name: str, **args) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "cat": cat, "ph": "e", "id": str(id),
                    "ts": self._ts(), "pid": 0, "tid": 0, "args": args})

    def instant(self, name: str, cat: str = "engine", **args) -> None:
        if not self.enabled:
            return
        self._emit({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": self._ts(), "pid": 0, "tid": 0, "args": args})

    # -- inspect / export ----------------------------------------------------

    @property
    def dropped_events(self) -> int:
        return max(0, self._n - self.capacity)

    def events(self) -> List[Dict]:
        """Buffered events, oldest first."""
        if self._n <= self.capacity:
            return [e for e in self._ring[:self._n]]
        start = self._n % self.capacity
        return self._ring[start:] + self._ring[:start]

    def chrome_trace(self) -> Dict:
        return {"traceEvents": self.events(),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped_events}}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as fh:
            for ev in self.events():
                fh.write(json.dumps(ev) + "\n")
