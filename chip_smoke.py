#!/usr/bin/env python3
"""Drive the PyTorch port's sliding-window inference path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. torch / CUDA versions and the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from catseg_tpu_torch/csrc (one nvcc per source,
   all at once, at first use).
3. Each of the six kernels of the path against its plain PyTorch version on
   the card, at the slice's shapes (2 images = 10 tiles, T = 150, 1500
   decoder slabs; the class layer also at T = 256, the top-k path's count),
   in fp32 (TF32 off) and bf16: max error against the stated bound, kernel,
   plain and (where one PyTorch call computes the same function) library
   times, median of 10 CUDA-event timings after warm-up.
4. The slice at the default configuration: a Predictor at
   eval_preset(vitb384()) — ViT-B/16 at full depth and width, bf16, the
   fused decoder, random weights from seed 0 — on the 150 ADE-20k class
   names; preds_sliding_batch on two synthetic uint8 images of different
   sizes.  Checks shapes, finite probabilities, labels in [0, 150), and that
   every kernel's launch count rose during that one run; reports images/s.
4b. The same slice with the plain decoder, eval_preset(vitb384(
   fused_decoder=False)) (the path of the first slice): every kernel but
   the decoder launched in one run, the decoder never; images/s.
5. fp32 parity of the default configuration: one image, the first 20 ADE
   classes, kernel path on the GPU against the same weights through the
   port on the CPU; max |d prob| must stay below 5e-4.
6. The top-k path: the 847 ADE-full names (pad_len 256 kept), bf16, the same
   two images: shapes, probabilities in [0, 1], labels in [0, 847), the
   class-layer and decoder counts rise; images/s.  Then fp32 parity of the
   top-k machinery (pad_len 16, the first 40 ADE-full names, one image, GPU
   against CPU): equal kept class sets, max |d prob| below 5e-4.
7. A ConfusionAccumulator on the card fed phase 4's predictions against a
   seeded synthetic ground truth with ignore pixels: its matrix must equal a
   numpy bincount of the same pairs.

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
    """Phase 3 for one dtype: {case: {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}}."""
    out, bad = {}, []
    for name, case in selfcheck.cases(dev, dtype).items():
        got = case.kernel()
        torch.cuda.synchronize()
        want = case.plain()
        torch.cuda.synchronize()
        err, rel = selfcheck.rel_err(got, want)
        del got, want
        k_ms, p_ms = time_ms(case.kernel), time_ms(case.plain)
        lib_ms = time_ms(case.library) if case.library is not None else None
        b_ms, b_by = selfcheck.bound_ms(case)
        bound = selfcheck.BOUND[dtype]
        log(f"  {name:16s} {str(dtype)[6:]:9s} max_abs_err {err:.3e} rel {rel:.3e} (bound {bound:.1e}) "
            f"kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms  library "
            f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'}  bound {b_ms:.4f} ms ({b_by})")
        if not rel <= bound:
            bad.append(name)
        out[name] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by}
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions in {dtype}: {bad}")
    return out


def run_counted(fn, _build):
    """fn() with every launch count set to 0 just before; returns (result, counts)."""
    torch.cuda.synchronize()
    _build.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    return res, dict(_build.LAUNCHES)


def images_per_s(pred, images, hws, canvas) -> tuple[float, float]:
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred.preds_sliding_batch(images, hws, canvas)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    return len(images) / med, med


def check_preds(preds, canvas, n_classes):
    preds = preds.cpu()
    if preds.shape != (2, *canvas) or preds.dtype != torch.int32:
        raise AssertionError(f"preds {tuple(preds.shape)} {preds.dtype}")
    if not ((preds >= 0) & (preds < n_classes)).all() or preds[1, 480:].any() or preds[1, :, 640:].any():
        raise AssertionError(f"labels outside [0, {n_classes}) or outside the image's true size")
    return preds


def check_probs(probs, n_classes):
    if probs.shape != (2, 640, 640, n_classes) or not torch.isfinite(probs.float()).all():
        raise AssertionError(f"probs {tuple(probs.shape)} not finite")
    if probs.min() < 0 or probs.max() > 1:
        raise AssertionError("probabilities outside [0, 1]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from catseg_tpu_torch.configs import class_names, eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import CATSeg, build_catseg, init_catseg_
    from catseg_tpu_torch.evaluation.miou import ConfusionAccumulator
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

    log("[3] kernels vs plain versions at the slice's shapes (10 tiles, T=150; class layer also T=256)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = {dt: check_kernels(dev, dt, selfcheck) for dt in (torch.float32, torch.bfloat16)}

    log("[4] sliding-window Predictor, default vitb384 eval preset (fused decoder), bf16, T=150")
    cfg = eval_preset(vitb384())
    names = class_names("ade150")
    pred = Predictor(build_catseg(cfg, seed=SEED), cfg, names)
    rng = np.random.RandomState(SEED)
    images = [rng.randint(0, 256, (512, 683, 3), dtype=np.uint8),
              rng.randint(0, 256, (480, 640, 3), dtype=np.uint8)]
    hws = np.array([im.shape[:2] for im in images], np.int32)
    canvas = (512, 683)
    pred.preds_sliding_batch(images, hws, canvas)          # warm-up (Triton JIT, cuDNN plans)
    preds, launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run: {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")
    preds = check_preds(preds, canvas, len(names))
    check_probs(pred.probs_sliding_batch(images), len(names))
    ips, med = images_per_s(pred, images, hws, canvas)
    log(f"    {ips:.3f} images/s (median of 3 2-image runs, {med * 1e3:.1f} ms) "
        f"on {smi}; {len(np.unique(preds.numpy()))} distinct labels")
    del pred
    torch.cuda.empty_cache()

    log("[4b] the same slice with the plain decoder, vitb384(fused_decoder=False), bf16, T=150")
    cfg_plain = eval_preset(vitb384(fused_decoder=False))
    pred = Predictor(build_catseg(cfg_plain, seed=SEED), cfg_plain, names)
    pred.preds_sliding_batch(images, hws, canvas)
    preds_plain, plain_launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run: {plain_launches}")
    if plain_launches["decoder"] or not all(n for k, n in plain_launches.items() if k != "decoder"):
        raise AssertionError("the plain-decoder path launched the decoder kernel or skipped another one")
    check_preds(preds_plain, canvas, len(names))
    ips_plain, med_plain = images_per_s(pred, images, hws, canvas)
    log(f"    {ips_plain:.3f} images/s with the plain decoder (median of 3 2-image runs, "
        f"{med_plain * 1e3:.1f} ms) on {smi}")
    del pred
    torch.cuda.empty_cache()

    log("[5] fp32 parity of the default configuration: GPU kernels vs the port on the CPU, 1 image, 20 classes")
    cfg32 = eval_preset(vitb384(compute_dtype="float32"))
    cpu_model = init_catseg_(CATSeg(cfg32), SEED).eval()
    gpu_pred = Predictor(copy.deepcopy(cpu_model), cfg32, names[:20])
    p_gpu, gpu_launches = run_counted(lambda: gpu_pred.probs_sliding_batch(images[1:]).cpu(), _build)
    p_cpu = Predictor(cpu_model, cfg32, names[:20], device="cpu").probs_sliding_batch(images[1:])
    d = (p_gpu - p_cpu).abs()
    agree = (p_gpu.argmax(-1) == p_cpu.argmax(-1)).float().mean().item()
    log(f"    max|d prob| {d.max().item():.3e} (bound {PROB_BOUND:.0e})  mean {d.mean().item():.3e}  "
        f"argmax agreement {agree:.5f}  kernel launches {gpu_launches}")
    if not d.max().item() < PROB_BOUND or min(gpu_launches.values()) == 0:
        raise AssertionError("fp32 GPU slice disagrees with the CPU port, or skipped a kernel")
    del gpu_pred, cpu_model

    log("[6] top-k path: 847 ADE-full names (pad_len 256 kept), bf16, the same 2 images")
    names847 = class_names("ade847")
    pred = Predictor(build_catseg(cfg, seed=SEED), cfg, names847)
    pred.preds_sliding_batch(images, hws, canvas)
    preds847, topk_launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run: {topk_launches}")
    if topk_launches["class_layer"] == 0 or topk_launches["decoder"] == 0:
        raise AssertionError("the top-k path skipped the class-layer or decoder kernel")
    check_preds(preds847, canvas, len(names847))
    check_probs(pred.probs_sliding_batch(images), len(names847))
    ips847, med847 = images_per_s(pred, images, hws, canvas)
    log(f"    {ips847:.3f} images/s at T=847 (median of 3 2-image runs, {med847 * 1e3:.1f} ms) on {smi}")
    del pred
    torch.cuda.empty_cache()

    cfg16 = eval_preset(vitb384(compute_dtype="float32", pad_len=16))
    cpu_model = init_catseg_(CATSeg(cfg16), SEED).eval()
    gpu_pred = Predictor(copy.deepcopy(cpu_model), cfg16, names847[:40])
    cpu_pred = Predictor(cpu_model, cfg16, names847[:40], device="cpu")
    tiles = cpu_pred._inputs(images[1:])

    def kept(p, batch):
        with torch.inference_mode():
            lg = p.model(torch.cat([batch[0][:, :384, :384], batch[1]]).to(p.device), p.text_feats).cpu()
        return [set(torch.nonzero(~(lg[i] == -100.0).flatten(1).all(1)).flatten().tolist()) for i in range(2)]

    k_gpu, k_cpu = kept(gpu_pred, tiles), kept(cpu_pred, tiles)
    p_gpu = gpu_pred.probs_sliding_batch(images[1:]).cpu()
    p_cpu = cpu_pred.probs_sliding_batch(images[1:])
    d = (p_gpu - p_cpu).abs()
    log(f"    fp32 top-k parity (pad_len 16 of 40 classes): kept sets equal {k_gpu == k_cpu} "
        f"({[len(k) for k in k_gpu]} kept)  max|d prob| {d.max().item():.3e} (bound {PROB_BOUND:.0e})")
    if k_gpu != k_cpu or any(len(k) != 16 for k in k_gpu) or not d.max().item() < PROB_BOUND:
        raise AssertionError("fp32 top-k path disagrees with the CPU port")
    del gpu_pred, cpu_pred, cpu_model

    log("[7] confusion matrix on the card vs numpy, phase 4's predictions")
    gt = np.random.RandomState(SEED + 1).randint(0, len(names), preds.shape).astype(np.int64)
    gt[np.random.RandomState(SEED + 2).rand(*gt.shape) < 0.1] = 255
    acc = ConfusionAccumulator(len(names), ignore_label=255)
    acc.update(preds.to(dev), torch.from_numpy(gt).to(dev))
    K = len(names)
    p_np = preds.numpy().astype(np.int64)
    want_cm = np.bincount((p_np * (K + 1) + np.where(gt == 255, K, gt)).ravel(),
                          minlength=(K + 1) ** 2).reshape(K + 1, K + 1)
    got_cm = acc.matrix()
    log(f"    {int(got_cm.sum())} pixels, matrix equal {np.array_equal(got_cm, want_cm)}, "
        f"mIoU {acc.metrics()['mIoU']:.3f} (random weights, random labels)")
    if acc.cm.device.type != "cuda" or not np.array_equal(got_cm, want_cm):
        raise AssertionError("device confusion matrix differs from the numpy bincount")

    kernels = []
    for name, route, source, replaces in selfcheck.KERNELS:
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], **checks[torch.bfloat16][name]})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
