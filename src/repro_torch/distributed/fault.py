"""Fault tolerance & straggler mitigation (``repro.distributed.fault``), plain
Python.

* :class:`StepWatchdog` — EMA step-time tracker that flags straggling
  steps (e.g. a slow host or preemption warning) and can trigger an early
  checkpoint.
* :func:`run_with_restarts` — wraps a training loop; on exception it
  reloads the latest checkpoint and resumes, up to ``max_restarts``.
  Because the data pipeline is seekable (pure function of step), resume
  is exact.
* :class:`Heartbeat` — background liveness file (cluster managers watch
  its mtime to detect hung workers and reschedule).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

log = logging.getLogger("repro_torch.fault")


class StepWatchdog:
    def __init__(self, ema: float = 0.9, threshold: float = 2.5, warmup: int = 5):
        self.ema = ema
        self.threshold = threshold
        self.warmup = warmup
        self._avg: Optional[float] = None
        self._n = 0
        self.straggler_events = 0

    def observe(self, step_time: float) -> bool:
        """Returns True if this step was a straggler."""
        self._n += 1
        if self._avg is None:
            self._avg = step_time
            return False
        is_straggler = (self._n > self.warmup
                        and step_time > self.threshold * self._avg)
        if is_straggler:
            self.straggler_events += 1
            log.warning("straggler step: %.3fs vs EMA %.3fs", step_time, self._avg)
        # don't poison the EMA with outliers
        if not is_straggler:
            self._avg = self.ema * self._avg + (1 - self.ema) * step_time
        return is_straggler


class Heartbeat:
    def __init__(self, path: str, interval: float = 10.0):
        self.path = path
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._beat, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _beat(self):
        while not self._stop.is_set():
            try:
                with open(self.path, "w") as f:
                    f.write(str(time.time()))
            except OSError:
                pass
            self._stop.wait(self.interval)

    def stop(self):
        self._stop.set()


def run_with_restarts(loop_fn: Callable[[int], int], resume_step_fn: Callable[[], int],
                      max_restarts: int = 3) -> int:
    """Run ``loop_fn(start_step) -> final_step``; on failure restart from
    ``resume_step_fn()`` (latest checkpoint), at most ``max_restarts``."""
    restarts = 0
    while True:
        start = resume_step_fn()
        try:
            return loop_fn(start)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — any worker failure
            restarts += 1
            if restarts > max_restarts:
                log.error("exceeded max_restarts=%d; giving up", max_restarts)
                raise
            log.warning("training loop failed (%s); restart %d from step %s",
                        e, restarts, resume_step_fn())
