"""``--profile DIR``: a torch.profiler trace (catseg_tpu/utils/profiling.py
wrote a jax.profiler one).  The chrome trace, with CUDA kernel events when
the card is in use, goes to ``DIR/trace.json``."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(log_dir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
