"""SLO-aware scheduling (``repro.serving.slo``): priority classes,
preemption with KV swap-to-host, and deadline- and cache-aware admission
policies.

Importing :mod:`repro_torch.serving.scheduler` registers the policies of
this package (``priority_strict``, ``edf``, ``cache_aware``) beside fcfs,
sjf and prefill_first; :class:`SwapManager` is the host-side block pool a
preempted request's KV lives in while it waits.
"""
from repro_torch.serving.slo.swap import SwapManager, SwapRecord

__all__ = ["SwapManager", "SwapRecord"]
