"""Admission scheduling for the continuous-batching engine
(``repro.serving.scheduler``), without the SLO hooks.

The scheduler owns request lifecycle: a waiting queue, a fixed pool of
``max_slots`` decode slots and the KV cache's reservations.  A request is
admissible when a slot is free and the cache can reserve its worst-case
block footprint.  *Which* admissible request goes next is an admission
policy from a registry keyed by ``ServeConfig.sched_policy``:

* ``fcfs`` — strict arrival order; a head that does not fit blocks the queue;
* ``sjf`` — smallest worst-case footprint first among arrived requests that fit;
* ``prefill_first`` — first fit in arrival order.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

from repro_torch.serving.request import Request, RequestState, Status

_POLICIES: Dict[str, "AdmissionPolicy"] = {}


def register_policy(cls: Type) -> Type:
    name = getattr(cls, "name", None)
    if not name or not isinstance(name, str):
        raise ValueError(f"policy class {cls!r} needs a string `name` attribute")
    _POLICIES[name] = cls()
    return cls


def get_policy(name: str) -> "AdmissionPolicy":
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown admission policy {name!r}; registered policies: "
            f"{', '.join(available_policies())}") from None


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_POLICIES))


class AdmissionPolicy:
    """Picks the index into ``waiting`` (arrival order) to admit next, or
    None to admit nothing now."""

    name = "abstract"

    def pick(self, waiting: Sequence[RequestState], clock_ms: float,
             fits: Callable[[RequestState], bool]) -> Optional[int]:
        raise NotImplementedError


@register_policy
class FCFSPolicy(AdmissionPolicy):
    name = "fcfs"

    def pick(self, waiting, clock_ms, fits):
        if not waiting:
            return None
        head = waiting[0]
        if head.request.arrival_ms > clock_ms or not fits(head):
            return None
        return 0


@register_policy
class SJFPolicy(AdmissionPolicy):
    name = "sjf"

    def pick(self, waiting, clock_ms, fits):
        best: Optional[int] = None
        for i, st in enumerate(waiting):
            r = st.request
            if r.arrival_ms > clock_ms or not fits(st):
                continue
            if best is None or ((r.total_len, r.arrival_ms, r.uid)
                                < (waiting[best].request.total_len,
                                   waiting[best].request.arrival_ms,
                                   waiting[best].request.uid)):
                best = i
        return best


@register_policy
class PrefillFirstPolicy(AdmissionPolicy):
    name = "prefill_first"

    def pick(self, waiting, clock_ms, fits):
        for i, st in enumerate(waiting):
            if st.request.arrival_ms <= clock_ms and fits(st):
                return i
        return None


class Scheduler:
    def __init__(self, max_slots: int, max_len: int, kv_cache=None,
                 policy: str = "fcfs", obs=None):
        self.max_slots = max_slots
        self.max_len = max_len
        self.kv_cache = kv_cache
        self.policy = get_policy(policy)
        if obs is None:
            from repro_torch.obs import Observability

            obs = Observability()
        self.obs = obs
        self.waiting: List[RequestState] = []
        self.running: Dict[int, RequestState] = {}     # slot -> state
        self.free_slots: List[int] = list(range(max_slots - 1, -1, -1))
        self._admit_seq = 0

    def add(self, request: Request) -> RequestState:
        if request.total_len > self.max_len:
            raise ValueError(
                f"request {request.uid}: prompt_len + max_new_tokens = "
                f"{request.total_len} exceeds serve max_len {self.max_len}")
        if self.kv_cache is not None:
            need = self.kv_cache.blocks_needed(request.total_len)
            if need > self.kv_cache.max_request_blocks:
                raise ValueError(
                    f"request {request.uid}: needs {need} KV blocks but a "
                    f"request can hold at most {self.kv_cache.max_request_blocks}")
        st = RequestState(request)
        self.waiting.append(st)
        self.obs.metrics.counter("sched_requests_total").inc()
        self.obs.request_arrived(request.uid, prompt_len=request.prompt_len,
                                 max_new_tokens=request.max_new_tokens)
        return st

    def _fits(self, st: RequestState) -> bool:
        if self.kv_cache is None:
            return True
        return self.kv_cache.can_allocate_slot(st.request.total_len,
                                               prompt=st.request.prompt)

    def admit(self, clock_ms: float) -> List[RequestState]:
        """Admit arrived requests under the policy while slots (and
        unreserved KV footprint) last; the slot is the LIFO free one."""
        admitted = []
        while self.free_slots:
            idx = self.policy.pick(self.waiting, clock_ms, self._fits)
            if idx is None:
                break
            st = self.waiting.pop(idx)
            slot = self.free_slots.pop()
            st.cached_tokens = 0
            if self.kv_cache is not None:
                # prefix caching binds the matched prompt-prefix blocks, so
                # prefill resumes at the first uncached token
                st.cached_tokens = self.kv_cache.allocate_slot(
                    slot, st.request.total_len, prompt=st.request.prompt)
            st.status = Status.PREFILL
            st.prefill_pos = st.cached_tokens
            st.slot = slot
            st.admitted_ms = clock_ms
            st.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.running[slot] = st
            self.obs.metrics.histogram("request_queue_ms").observe(
                max(clock_ms - st.request.arrival_ms, 0.0))
            self.obs.request_phase(st.request.uid, "prefill", slot=slot)
            admitted.append(st)
        return admitted

    def finish(self, st: RequestState, clock_ms: float) -> None:
        if self.running.get(st.slot) is not st:
            raise RuntimeError(f"request {st.request.uid} is not running in slot {st.slot}")
        del self.running[st.slot]
        self.free_slots.append(st.slot)
        if self.kv_cache is not None:
            # confirm the written context (prompt + every fed-back sample)
            # so the slot's full blocks are published before they are
            # released: they land on the cached-free list, matchable
            self.kv_cache.commit(st.slot, st.confirmed_tokens)
            self.kv_cache.free_slot(st.slot)
        st.status = Status.FINISHED
        st.finished_ms = clock_ms
        m = self.obs.metrics
        m.counter("sched_finished_total").inc()
        m.counter("generated_tokens_total").inc(len(st.generated))
        m.counter("prefix_cached_tokens_total").inc(st.cached_tokens)
        m.counter("prefix_prompt_tokens_total").inc(st.request.prompt_len)
        m.histogram("request_latency_ms").observe(st.latency_ms())
        self.obs.request_finished(st.request.uid)

    @property
    def prefilling(self) -> Optional[RequestState]:
        """The earliest-admitted PREFILL request: the one that makes
        prefill progress this step."""
        cands = [st for st in self.running.values() if st.status is Status.PREFILL]
        return min(cands, key=lambda s: s.admit_seq) if cands else None

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def next_arrival_ms(self) -> Optional[float]:
        if not self.waiting:
            return None
        return min(st.request.arrival_ms for st in self.waiting)

    def check_conservation(self) -> None:
        if (len(self.free_slots) + len(self.running) != self.max_slots
                or not set(self.free_slots).isdisjoint(self.running.keys())):
            raise AssertionError("scheduler: slots are not exactly free or running")
        if self.kv_cache is not None:
            self.kv_cache.check_conservation()
        for st in self.waiting:
            if st.status is not Status.QUEUED:
                raise AssertionError(f"scheduler: waiting request {st.request.uid} "
                                     f"is {st.status}")
