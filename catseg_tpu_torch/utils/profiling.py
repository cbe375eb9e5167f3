"""Memory accounting and ``--profile DIR`` traces (catseg_tpu/utils/profiling.py).

``device_memory_stats`` reads ``torch.cuda``'s allocator statistics where
the JAX package read ``jax.devices()``' memory stats; ``trace`` writes a
torch.profiler chrome trace (with CUDA kernel events when the card is in
use) to ``DIR/trace.json`` where the JAX package wrote a jax.profiler one.
"""

from __future__ import annotations

import contextlib
import os


def device_memory_stats() -> dict:
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}} for
    every visible card: bytes the caching allocator holds in tensors now,
    its peak since the last ``torch.cuda.reset_peak_memory_stats``, and the
    card's total memory.  Empty without a card."""
    import torch

    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {"bytes_in_use": torch.cuda.memory_allocated(i),
                          "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                          "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
            for i in range(torch.cuda.device_count())}


@contextlib.contextmanager
def trace(log_dir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
