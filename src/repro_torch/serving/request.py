"""Request model for the continuous-batching engine (a copy of the parts
of ``repro.serving.request`` the port's engine uses).

A :class:`Request` is what a client submits: prompt tokens, a generation
budget and an arrival time (milliseconds on the serving clock — 0 for
"already here", or trace-driven Poisson arrivals), and for SLO-aware
scheduling (``repro_torch.serving.slo``) a :class:`Priority` class plus an
optional latency target: an absolute ``deadline_ms``, or a
``slo_tokens_per_s`` rate the deadline is derived from.  A
:class:`RequestState` is the scheduler's view of one admitted request: its
decode slot, how far prefill has progressed, what has been generated so
far, and (under preemption) the host-side swap record its KV blocks live
in while it is off the device.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class Priority(enum.IntEnum):
    """Request priority class: lower value = more urgent.  Policies and
    victim selection compare the int values, so a plain ``int`` works
    anywhere a Priority does."""

    HIGH = 0
    NORMAL = 1
    LOW = 2


class Status(enum.Enum):
    QUEUED = "queued"        # waiting for a slot / KV blocks
    PREFILL = "prefill"      # admitted; prompt (or resume) chunks being ingested
    DECODE = "decode"        # one token per engine step
    PREEMPTED = "preempted"  # evicted mid-flight; KV swapped to host, requeued
    FINISHED = "finished"    # evicted; slot and blocks returned
    SHED = "shed"            # rejected at the door: deadline provably unmeetable


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (prompt_len,) int32 token ids
    max_new_tokens: int
    arrival_ms: float = 0.0
    eos_id: Optional[int] = None
    # SLO model: a priority class, and at most one way of stating a latency
    # target (an absolute completion deadline, or a sustained token rate
    # the deadline is derived from)
    priority: Priority = Priority.NORMAL
    deadline_ms: Optional[float] = None
    slo_tokens_per_s: Optional[float] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, dtype=np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.uid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.uid}: max_new_tokens must be >= 1")
        try:
            if isinstance(self.priority, str):
                self.priority = Priority[self.priority.upper()]
            elif not isinstance(self.priority, Priority):
                self.priority = Priority(self.priority)
        except KeyError:
            raise ValueError(
                f"request {self.uid}: unknown priority {self.priority!r}; "
                f"expected one of {[p.name.lower() for p in Priority]}") from None
        if self.slo_tokens_per_s is not None and self.slo_tokens_per_s <= 0:
            raise ValueError(f"request {self.uid}: slo_tokens_per_s must be > 0")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def total_len(self) -> int:
        """Upper bound on context positions this request can occupy."""
        return self.prompt_len + self.max_new_tokens

    @property
    def effective_deadline_ms(self) -> Optional[float]:
        """The completion deadline the SLO implies: ``deadline_ms`` when
        given, else arrival + the worst-case generation at
        ``slo_tokens_per_s``, else None (no deadline)."""
        if self.deadline_ms is not None:
            return self.deadline_ms
        if self.slo_tokens_per_s is not None:
            return self.arrival_ms + 1e3 * self.max_new_tokens / self.slo_tokens_per_s
        return None


@dataclasses.dataclass
class RequestState:
    request: Request
    slot: int = -1
    status: Status = Status.QUEUED
    prefill_pos: int = 0             # context tokens already ingested
    cached_tokens: int = 0           # prompt tokens served from the prefix cache
    generated: List[int] = dataclasses.field(default_factory=list)
    admitted_ms: float = 0.0
    admit_seq: int = -1              # admission order (the prefilling tiebreak)
    first_token_ms: Optional[float] = None
    finished_ms: Optional[float] = None
    preemptions: int = 0             # times this request was swapped out
    swap_record: Optional[object] = None  # SwapRecord while PREEMPTED

    @property
    def last_token(self) -> int:
        """Token to feed next in decode (the most recent sample)."""
        return self.generated[-1]

    @property
    def confirmed_tokens(self) -> np.ndarray:
        """The prompt plus every generated token that has been fed back
        (all samples except the newest): the token stream behind every KV
        position this request can have written, and the prefill stream a
        restored preempted request re-ingests (or re-binds)."""
        if self.generated:
            return np.concatenate(
                [self.request.prompt, np.asarray(self.generated[:-1], np.int32)])
        return self.request.prompt

    @property
    def prefill_target(self) -> int:
        """Context length at which prefill completes and decode starts: the
        prompt length for a fresh request, the whole confirmed stream for a
        preempted one resuming mid-decode."""
        return int(self.confirmed_tokens.size)

    @property
    def context_len(self) -> int:
        """KV positions written so far."""
        if self.status is Status.PREFILL:
            return self.prefill_pos
        return self.request.prompt_len + max(len(self.generated) - 1, 0)

    def done(self) -> bool:
        if len(self.generated) >= self.request.max_new_tokens:
            return True
        eos = self.request.eos_id
        return eos is not None and len(self.generated) > 0 and self.generated[-1] == eos

    def latency_ms(self) -> Optional[float]:
        if self.finished_ms is None:
            return None
        return self.finished_ms - self.request.arrival_ms

    def slack_ms(self, clock_ms: float) -> float:
        """Time left until the effective deadline (+inf without one);
        negative once it is missed."""
        d = self.request.effective_deadline_ms
        return float("inf") if d is None else d - clock_ms

    def met_deadline(self) -> Optional[bool]:
        """True/False once finished and a deadline exists, else None."""
        d = self.request.effective_deadline_ms
        if d is None or self.finished_ms is None:
            return None
        return self.finished_ms <= d
