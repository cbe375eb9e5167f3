"""Where the time of one train step goes, on the card.

    python -m catseg_tpu_torch.tools.profile_train [--config vitb384] [--no-recompute] [--out profile_out]

Builds the train state at the ``--config`` preset of ``tools.common``
(default ``vitb384()``: bf16, pooling 2x2, the fused decoder; also
``fusion_ver31``, ``fusion_ver14``, ...; random weights from seed ``SEED``)
on the 171 COCO-Stuff train prompts and a synthetic batch of 4 uint8 384^2
crops, and after a warm-up step measures:

- the step (host clock ending in ``torch.cuda.synchronize()``, median of
  ``REPS``);
- device time per kernel entry point in one step: every CUDA launch
  (``_build.launch``, the LayerNorm's too) is bracketed by CUDA events on
  its stream; the rest of the step (CLIP matmuls and the text
  tower's attention in plain PyTorch, the BCE, casts, the optimizer) is the
  step minus their sum;
- one step under ``torch.profiler``: the device's busy time (the union of
  the kernel intervals), its idle share of the step's host wall time, the
  device time by category (``profile_slice.categorize``) and the 15 kernel
  names with the most device time;
- the allocator's peak over the warm-up step (``peak_gib``).

``--no-recompute`` keeps every Ver14 refinement step's activations for the
backward instead of recomputing them (``core.fusion.sam_mask_refine``).

Prints one JSON object and writes it, with the trace, under ``--out``.
Needs an NVIDIA GPU; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .profile_slice import categorize

SEED = 0
REPS = 3


def _bracket(timings: list, name: str, fn):
    """fn wrapped so each call records (name, start, end) CUDA events."""
    def wrapped(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn(*a, **kw)
        e.record()
        timings.append((name, s, e))
        return out
    return wrapped


def parse_args(argv=None):
    """(arguments, the ``--config`` preset's config)."""
    from .common import resolve_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="vitb384", help="a preset of tools.common")
    ap.add_argument("--no-recompute", action="store_true",
                    help="Ver14: keep each refinement step's activations instead of recomputing them")
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args(argv)
    cfg = resolve_config(args.config, [])
    if args.no_recompute and (cfg.fusion is None or cfg.fusion.mode != "sam_refine"):
        raise SystemExit(f"--no-recompute is a Ver14 option; {args.config} has no mask refinement")
    return args, cfg


def main(argv=None) -> dict:
    args, cfg = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..configs import class_names
    from ..kernels import _build
    from ..train.loop import class_tokens, init_train_state, make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    names = class_names("coco")
    state = init_train_state(cfg, seed=SEED)
    if args.no_recompute:
        state.model.recompute_refinement = False
    step = make_train_step(cfg, state.optimizer, class_tokens(names))
    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.randint(0, 256, (4, 384, 384, 3), dtype=np.uint8)).cuda()
    targets = torch.from_numpy(rng.randint(0, len(names), (4, 384, 384))).cuda()
    run = lambda: step(state.model, images, targets)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    secs = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    step_ms = statistics.median(secs) * 1e3

    timings: list = []
    launch = _build.launch
    _build.launch = lambda name, *a, _f=launch: _bracket(timings, name.removeprefix("catseg_"), _f)(name, *a)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        _build.launch = launch
    per: dict[str, list] = {}
    for name, s, e in timings:
        per.setdefault(name, []).append(s.elapsed_time(e))
    kernels = {k: {"launches": len(v), "ms": sum(v)} for k, v in sorted(per.items(), key=lambda kv: -sum(kv[1]))}
    in_kernels = sum(v["ms"] for v in kernels.values())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("batch"):
            run()
            torch.cuda.synchronize()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stem = "" if args.config == "vitb384" else f"_{args.config}"
    trace_path = out / f"trace_train{stem}.json"
    prof.export_chrome_trace(str(trace_path))
    trace = json.loads(trace_path.read_text())
    by_cat, busy, span, wall = categorize(trace)
    top: dict[str, float] = {}
    for ev in trace["traceEvents"]:
        if ev.get("cat") == "kernel":
            top[ev["name"][:240]] = top.get(ev["name"][:240], 0.0) + ev["dur"] / 1e3
    config = f"{args.config}() bf16, B=4, T=171, 384^2 crops" + (", no recompute" if args.no_recompute else "")
    res = {"card": card, "config": config, "step_ms": step_ms, "images_per_s": 4e3 / step_ms, "peak_gib": peak_gib,
           "kernel_ms": kernels, "outside_kernels_ms": step_ms - in_kernels, "profiled_wall_ms": wall,
           "device_busy_ms": busy, "kernel_span_ms": span, "idle_share": 1 - busy / wall, "device_ms_by_category": by_cat,
           "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:15])}
    (out / f"profile_train{stem}.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
