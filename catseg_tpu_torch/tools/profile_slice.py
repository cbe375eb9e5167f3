"""Where the time of one sliding-window batch goes, on the card.

    python -m catseg_tpu_torch.tools.profile_slice [--benchmark ade150] [--out profile_out]

Builds the default serving configuration, ``eval_preset(vitb384())`` (bf16,
the fused decoder, random weights from seed ``SEED``), on the benchmark's class
names and two synthetic uint8 images of 512x683 and 480x640 (10 tiles), and
after a warm-up measures:

- stage times with CUDA events (median of ``REPS``): the whole
  ``preds_sliding_batch``, the model forward on the 10 tiles, and its CLIP
  encode + guidance pyramid; the aggregator is the forward minus CLIP and
  the tail (resize, sigmoid, fold, resize-argmax) the batch minus the forward;
- one batch under ``torch.profiler`` (CPU + CUDA activities), from the
  exported chrome trace: device time summed by kernel category (the
  ``"cat": "kernel"`` events), the device's busy time (the union of the
  kernel intervals) and its idle share of the batch's wall time on the host
  (a ``record_function`` span around the batch and its final synchronize).

Prints one JSON object and writes it, with the trace, under ``--out``.
Needs an NVIDIA GPU; it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

# device kernel name -> category, first match wins
CATEGORIES = (
    ("swin kernel", r"swin_block"),
    ("class-layer kernel", r"class_layer"),
    ("decoder kernel", r"decoder_kernel"),
    ("dense-attention kernel", r"dense_attention"),
    ("corr-embed kernel", r"corr_embed"),
    ("LayerNorm kernel", r"layer_norm_kernel"),
    ("cuDNN convolutions + layout transposes", r"conv|cudnn|xmma|nchw|nhwc|implicit|Kernel2?D?_?Transpose"),
    ("matmuls (cuBLAS / CUTLASS)", r"gemm|cutlass|cublas|sm90_"),
    ("resizes", r"upsample|interp|bilinear|bicubic"),
    ("GroupNorm", r"group_norm|GroupNorm|RowwiseMoments|ComputeFusedParams"),
    ("reductions / argmax / top-k", r"reduce|argmax|topk|sort|radix|max"),
    ("copies, casts, cat / stack", r"copy|cast|CatArray|to_copy|direct_copy|fill"),
    ("other elementwise", r"elementwise|vectorized|unrolled"),
)
SEED = 0
REPS = 5


def cuda_ms(fn) -> float:
    times = []
    for _ in range(REPS):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def categorize(trace: dict) -> tuple[dict, float, float, float]:
    """(device ms by category, busy ms as the union of kernel intervals,
    first-to-last kernel span ms, host wall ms of the ``batch`` span)."""
    kernels = [ev for ev in trace["traceEvents"] if ev.get("cat") == "kernel"]
    wall = next(ev["dur"] for ev in trace["traceEvents"]
                if ev.get("cat") == "user_annotation" and ev.get("name") == "batch") / 1e3
    by_cat: dict[str, float] = {}
    for ev in kernels:
        name = ev["name"]
        cat = next((c for c, pat in CATEGORIES if re.search(pat, name)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + ev["dur"] / 1e3
    spans = sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
    return dict(sorted(by_cat.items(), key=lambda kv: -kv[1])), busy / 1e3, span, wall


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--benchmark", default="ade150")
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..configs import class_names, eval_preset, vitb384
    from ..core.catseg import build_catseg, normalize_clip
    from ..infer.pipeline import Predictor
    from ..ops import resize_bilinear, unfold_tiles

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = eval_preset(vitb384())
    names = class_names(args.benchmark)
    pred = Predictor(build_catseg(cfg, seed=SEED), cfg, names)
    rng = np.random.RandomState(SEED)
    images = [rng.randint(0, 256, (512, 683, 3), dtype=np.uint8),
              rng.randint(0, 256, (480, 640, 3), dtype=np.uint8)]
    hws = np.array([im.shape[:2] for im in images], np.int32)
    canvas = (512, 683)
    batch = lambda: pred.preds_sliding_batch(images, hws, canvas)  # noqa: E731
    img640s, imgks = pred._inputs(images)
    tiles = torch.cat([unfold_tiles(img640s, cfg.sw_kernel, cfg.sw_stride), imgks])
    clip_in = resize_bilinear(normalize_clip(tiles), (cfg.clip_resolution,) * 2)
    with torch.inference_mode():
        batch()
        torch.cuda.synchronize()
        t_batch = cuda_ms(batch)
        t_fwd = cuda_ms(lambda: pred.model(tiles, pred.text_feats))
        t_clip = cuda_ms(lambda: pred.model.guidance_features(clip_in))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("batch"):
                batch()
                torch.cuda.synchronize()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trace_path = out / f"trace_{args.benchmark}.json"
    prof.export_chrome_trace(str(trace_path))
    by_cat, busy, span, wall = categorize(json.loads(trace_path.read_text()))
    res = {"card": card, "config": "eval_preset(vitb384()) bf16", "benchmark": args.benchmark,
           "classes": len(names), "images": 2, "tiles": 10,
           "batch_ms": t_batch, "images_per_s": 2e3 / t_batch, "forward_ms": t_fwd, "clip_guidance_ms": t_clip,
           "aggregator_ms": t_fwd - t_clip, "tail_ms": t_batch - t_fwd,
           "profiled_wall_ms": wall, "device_busy_ms": busy, "kernel_span_ms": span,
           "idle_share": 1 - busy / wall, "device_ms_by_category": by_cat}
    (out / f"profile_{args.benchmark}.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
