"""A ``torch.profiler`` trace of a span of a run, for the CLIs'
``--profile-dir`` (the reference's ``jax.profiler`` trace of the same
span)."""
from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def device_trace(profile_dir, device):
    """A ``torch.profiler`` trace of the block (the CPU, and CUDA activity
    when ``device`` is a card) written to ``<profile_dir>/trace.json`` as a
    Chrome trace; nothing when ``profile_dir`` is None (the reference's
    ``jax.profiler`` trace of the same span)."""
    if profile_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profile -> {path}")
