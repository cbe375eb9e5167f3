#!/usr/bin/env python3
"""Drive the PyTorch port's sliding-window inference path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. torch / CUDA versions and the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from catseg_tpu_torch/csrc (nvcc at first use).
3. Each of the five kernels of the path against its plain PyTorch version
   on the card, at the slice's shapes (2 images = 10 tiles, T = 150), in
   fp32 (TF32 off) and bf16: max error against the stated bound, kernel and
   plain times (median of 10 CUDA-event timings after warm-up).
4. The slice: a Predictor at eval_preset(vitb384(fused_decoder=False)) —
   ViT-B/16 at full depth and width, bf16 compute, random weights from seed
   0 — on the 150 ADE-20k class names; preds_sliding_batch on two synthetic
   uint8 images of different sizes.  Checks shapes, finite probabilities,
   labels in [0, 150), and that every kernel's launch count rose during that
   one run; reports images/s.
5. fp32 parity of the whole slice: one image, the first 20 ADE classes,
   kernel path on the GPU against the same weights through the port on the
   CPU; max |d prob| must stay below 5e-4.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and before that a JSON line with one entry
per kernel.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PROB_BOUND = 5e-4   # fp32 GPU-vs-CPU max |d prob| (the README's oracle bound)
SEED = 0


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernels(dev, dtype, selfcheck) -> dict:
    """Phase 3 for one dtype: {name: (max_abs_err, kernel_ms, plain_ms)}."""
    out, bad = {}, []
    for name, (kernel, plain) in selfcheck.cases(dev, dtype).items():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        torch.cuda.synchronize()
        err, rel = selfcheck.rel_err(got, want)
        del got, want
        k_ms, p_ms = time_ms(kernel), time_ms(plain)
        bound = selfcheck.BOUND[dtype]
        log(f"  {name:16s} {str(dtype)[6:]:9s} max_abs_err {err:.3e} rel {rel:.3e} (bound {bound:.1e}) "
            f"kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms")
        if not rel <= bound:
            bad.append(name)
        out[name] = (err, k_ms, p_ms)
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions in {dtype}: {bad}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from catseg_tpu_torch.configs import class_names, eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.kernels import _build, selfcheck

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[1] python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"devices {torch.cuda.device_count()}  card: {smi}")

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s -> {lib}")

    log("[3] kernels vs plain versions at the slice's shapes (10 tiles, T=150)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = {dt: check_kernels(dev, dt, selfcheck) for dt in (torch.float32, torch.bfloat16)}

    log("[4] sliding-window Predictor, vitb384 eval preset, fused_decoder=False, bf16, T=150")
    cfg = eval_preset(vitb384(fused_decoder=False))
    names = class_names("ade150")
    model = init_catseg_(CATSeg(cfg), SEED).to(dev).eval()
    pred = Predictor(model, cfg, names)
    rng = np.random.RandomState(SEED)
    images = [rng.randint(0, 256, (512, 683, 3), dtype=np.uint8),
              rng.randint(0, 256, (480, 640, 3), dtype=np.uint8)]
    hws = np.array([im.shape[:2] for im in images], np.int32)
    canvas = (512, 683)
    pred.preds_sliding_batch(images, hws, canvas)          # warm-up (Triton JIT, cuDNN plans)
    torch.cuda.synchronize()
    _build.reset_launches()
    preds = pred.preds_sliding_batch(images, hws, canvas)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"    launches in one 2-image run: {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")
    preds = preds.cpu()
    if preds.shape != (2, *canvas) or preds.dtype != torch.int32:
        raise AssertionError(f"preds {tuple(preds.shape)} {preds.dtype}")
    if not ((preds >= 0) & (preds < len(names))).all() or preds[1, 480:].any() or preds[1, :, 640:].any():
        raise AssertionError("labels outside [0, 150) or outside the image's true size")
    probs = pred.probs_sliding_batch(images)
    if probs.shape != (2, 640, 640, len(names)) or not torch.isfinite(probs.float()).all():
        raise AssertionError(f"probs {tuple(probs.shape)} not finite")
    if probs.min() < 0 or probs.max() > 1:
        raise AssertionError("probabilities outside [0, 1]")
    del probs
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred.preds_sliding_batch(images, hws, canvas)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    log(f"    {len(images) / med:.3f} images/s (median of 3 2-image runs, {med * 1e3:.1f} ms) "
        f"on {smi}; {len(np.unique(preds.numpy()))} distinct labels")
    del pred, model
    torch.cuda.empty_cache()

    log("[5] fp32 slice parity: GPU kernels vs the port on the CPU, 1 image, 20 classes")
    cfg32 = eval_preset(vitb384(fused_decoder=False, compute_dtype="float32"))
    cpu_model = init_catseg_(CATSeg(cfg32), SEED).eval()
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    _build.reset_launches()
    p_gpu = Predictor(gpu_model, cfg32, names[:20]).probs_sliding_batch(images[1:]).cpu()
    gpu_launches = dict(_build.LAUNCHES)
    p_cpu = Predictor(cpu_model, cfg32, names[:20]).probs_sliding_batch(images[1:])
    d = (p_gpu - p_cpu).abs()
    agree = (p_gpu.argmax(-1) == p_cpu.argmax(-1)).float().mean().item()
    log(f"    max|d prob| {d.max().item():.3e} (bound {PROB_BOUND:.0e})  mean {d.mean().item():.3e}  "
        f"argmax agreement {agree:.5f}  kernel launches {gpu_launches}")
    if not d.max().item() < PROB_BOUND or min(gpu_launches.values()) == 0:
        raise AssertionError("fp32 GPU slice disagrees with the CPU port, or skipped a kernel")

    kernels = []
    for name, route, source, replaces in selfcheck.KERNELS:
        err, k_ms, p_ms = checks[torch.bfloat16][name]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
