#!/usr/bin/env python3
"""Drive the PyTorch port's inference and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. torch / CUDA versions and the card's name and power limit (nvidia-smi).
2. Build the CUDA kernels from catseg_tpu_torch/csrc (one nvcc per source,
   all at once, at first use).
3. Each of the twelve kernels against its plain PyTorch version on the card,
   in fp32 (TF32 off) and bf16: the six forward kernels at the serving
   slice's shapes (2 images = 10 tiles, T = 150, 1500 decoder slabs; the
   class layer also at T = 256, the top-k path's count), the three backward
   kernels at the train step's (4 images, T = 171, the class layer on the
   12x12 pooled grid, 684 decoder slabs; every gradient checked by its
   relative Frobenius error, the worst max-norm error logged beside it),
   the three kernels of the aggregator's unfused stages at the serving
   slab's (window attention over 6000 windows of 144 tokens; the class MLP
   at 1,474,560 rows and the Swin MLP at 864,000; linear attention over 5760
   sequences of 256 classes; window attention also on the strided views
   of a fused qkv projection with no mask, as the unfused Swin block's
   unshifted half calls it, and at window 16, 1500 windows of 256 tokens):
   each case's kernel call must raise its
   kernel's launch count; the error against the stated bound, kernel,
   plain and (where one PyTorch call computes the same function) library
   times and kernel / library, median of CUDA-event timings after warm-up
   (a call under 1 ms timed over 20 back-to-back calls).  Also at the larger
   encoder tiers' shapes: LayerNorm at rows of 1024, 1280 and 1664, the dense
   attention at 16 heads of 64 (width 1024), the corr embed at E 768, 1024
   and 1280.
4. The slice at the default configuration: a Predictor at
   eval_preset(vitb384()) — ViT-B/16 at full depth and width, bf16, the
   fused decoder, random weights from seed 0 — on the 150 ADE-20k class
   names; preds_sliding_batch on two synthetic uint8 images of different
   sizes.  Checks shapes, finite probabilities, labels in [0, 150), and that
   every kernel of the default route's launch count rose during that one
   run and the unfused stages' kernels never launched; reports images/s.
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
8. The train step at full width: vitb384() (bf16, pooling 2x2, fused
   decoder, CLIP q/v finetune, AdamW recipe), seed 0, the 171 COCO-Stuff
   train prompts, 4 synthetic 384^2 crops with targets in [0, 171) and ~10%
   ignore: one counted warm-up step (every forward and backward kernel
   launched, the unfused stages' never; finite loss), 20 steps each timed
   on the host clock to a synchronize (ms/step as median, min and max;
   images/s at the median), frozen parameters bit-equal and > 90% of the
   trainable tensors moved.
9. fp32 train-step parity, vitb384(compute_dtype="float32"), 1 crop, the
   first 8 classes (pad terms live), the same weights on the GPU (kernels)
   and the CPU (the port's plain path): loss within 1e-5 relative, every
   trainable gradient before the clip within 1e-3 of its largest CPU value,
   and after one update frozen tensors equal and trainables moved.
10. Serving with attention_type="full" (the reference's other class
   aggregation): eval_preset(vitb384(attention_type="full")), bf16, the
   same two images at T = 150.  Every class layer takes the unfused stage
   (pad to 256 tokens, LN, fp32 softmax attention, LN, the ReLU MLP kernel
   at 1,474,560 rows): the mlp count rises, the class-layer kernel's stays
   0; shapes, probabilities in [0, 1], labels in range; images/s.
11. Its fp32 parity, GPU against the port on the CPU (1 image, 20 classes):
   max |d prob| below 5e-4, as [5].
12. The train step at vitb384(attention_type="full") (pooling 2x2, B = 4,
   T = 171): the MLP kernel forward at 147,456 rows with the plain
   backward, the class-layer kernels never; finite loss, ms/step over 20
   steps as [8], trainables moved.
13. The unfused stages against the fused kernels at full width, in fp32 and
   bf16, as catseg_tpu's own tests hold them equal: the unfused Swin pair
   (window attention twice, the GELU MLP twice) against fused_swin_pair on
   the serving slab (10, 150, 24, 24, 128) with appearance guidance; the
   unfused linear class stage (linear attention, the ReLU MLP) against the
   class-layer kernel at T = 150, pad_len 256, pooling 1x1, and at the
   train shapes (4, 171) with pooling 2x2.  Bounds: fp32 2e-4, bf16 2^-5,
   of max(1, |fused|); the window-attention, MLP and linear-attention
   counts rise.  Each stage's time on both routes is logged.
14. The bf16 gate (catseg_tpu_torch/tools/bf16_gate.py), as the reference
   bounds its production dtype
   (tests/test_fullscale_parity_more.py::test_bf16_drift_fullscale): one
   seeded 427x640 image, 150 random unit text features, the same seeded
   weights (GATE_SEED; why that seed, the tool says) at
   eval_preset(vitb384(compute_dtype=dt)) for fp32 and bf16,
   probs_sliding_batch on the card both ways.  max |d prob| < 0.02, mean <
   2e-3, and argmax agreement > 0.99 on the pixels whose fp32 top-2 gap
   exceeds 0.01 (there must be some); the bf16 run raises every forward
   kernel's count.
15. The single-image API on the whole-image branch, the model's default
   configuration: Predictor(vitb384()) (sliding_window=False, pooling 2x2,
   bf16, random weights from seed 0) on the 150 ADE-20k names;
   predict_argmax on phase 4's two images.  One counted run must launch
   each forward kernel and no backward or unfused-stage kernel; labels of
   each image's size in [0, 150).  Every forward-kernel call of one
   probs_whole (the class layer on the 12x12 pooled grid outside autograd,
   the decoder at 150 slabs, ...) is recorded and its kernel held against
   its plain version on the same bf16 inputs, at [3]'s bound 2^-5;
   images/s at the median of 20 host-clock 2-image runs, with min and max.
16. fp32 parity of the single-image API, vitb384(compute_dtype="float32"),
   one image, 20 classes, GPU kernels against the port on the CPU:
   probs_whole max |d prob| below 5e-4, predict_argmax's labels equal on >=
   99.9% of pixels; probs_sliding under eval_preset below 5e-4 (against
   phase 5's CPU result, the same function) and equal, exactly, to row 0 of
   probs_sliding_batch on the card.
17. The aggregator's routes at geometries some kernels do not take
   (kernels/selfcheck.py ROUTES: hidden 256, one head, hidden 512, ...),
   fp32, T = 8, random weights and features.  No route picks a plain
   version on the card: where a kernel the routes call refuses the
   geometry the card must raise NotImplementedError naming it; elsewhere
   the run launches exactly the kernels the routes name (LayerNorm aside)
   and its sigmoid probabilities match the port on the CPU below 5e-4.
18. The host data path: the host C++ library built with this machine's g++;
   every committed fixture (tests/torch_fixtures: JPEGs 4:2:0 / 4:4:4 /
   progressive / grey, L / P / RGBA PNGs, a uint16 TIFF, the 4-image
   dataset) decodes to the sha256 of the imaging library's arrays in
   digests.json, and the 480x640 JPEG's resize_shortest_edge(640, 2560) to
   its digest (and to the resize's numpy specification); decode and resize
   ms of that JPEG, median of 10, on the host CPU.
19. tools.eval.main on the fixture dataset (4 images, two sizes, ADE-150
   layout): vitb384, eval preset, bf16, random weights from seed 0,
   --eval-batch 2 then 1.  Each run launches every forward kernel; 4 images,
   finite metrics, equal metrics and confusion matrices for batch 2 and 1,
   and the matrix equals a ConfusionAccumulator fed
   Predictor.preds_sliding_batch on the same loaded inputs.  Images/s of the
   harness with decode and resize included (median of 3 passes) beside the
   Predictor alone on those inputs and [4]'s.  Then the steady state: the
   harness over 256 entries of the 480x640 JPEG (each with a 480x640 PNG
   label map, written to a temporary ADE-150 layout) beside the Predictor
   alone on the same loaded inputs, and the harness's load ms an image.
20. TTAPredictor with D2's 9 scales (400..1200, max 4000) x hflip on the
   480x640 fixture JPEG (bf16, T = 150): 18 passes an image, probabilities
   finite in [0, 1], every forward kernel launched; ms an image, median of
   3.  Then fp32, scale 400 x hflip, 20 classes: GPU against the port on the
   CPU below 5e-4, as [16].
21. tools.train.main: vitb384 (bf16, pooling 2x2), B = 4, 3 steps on the
   fixture dataset through the train mapper and its prefetch thread:
   finite losses in metrics.json, every forward and backward kernel
   launched, model_final.pth written; then tools.eval --checkpoint of it
   scores the 4 images.  Host ms a batch of 4 of the mapper on 480x640
   JPEGs and label maps, median of 10.
22. The larger encoder tiers at full width and depth, seeded random weights
   (seed 0), eval_preset, bf16, T = 150 on phase 4's two images:
   vitl336() (CAT-Seg (L), CLIP ViT-L/14@336), vith336() (open_clip
   ViT-H-14) and vitg336() (ViT-bigG-14), one at a time, each freed before
   the next.  Per tier: parameters, seeded-init seconds, device memory
   (utils/profiling.device_memory_stats), the launches of one counted run
   (L: every forward kernel; H and G, head dims 80 and 104: every forward
   kernel but the dense attention, whose gate is the reference's; no
   backward or unfused-stage kernel), shapes and ranges as [4], images/s
   (median of 3).  For vitl336 also the T = 459 batch (PC-459, top-k to
   pad_len 256) and one whole-image predict_argmax (vitl336(), pooling 2x2).
23. fp32 parity of vitl336(compute_dtype="float32"): one whole-image forward
   (probs_whole), 20 classes, GPU kernels against the port on the CPU, max
   |d prob| below 5e-4.
24. The vitl336() train step, as [8]: B = 4, T = 171, pooling 2x2, every
   forward and backward kernel launched, frozen weights bit-equal, 20 timed
   steps.
25. The converter on the card: a seeded vitl336 model's state dict with each
   CLIP attention's q / k / v fused into in_proj_weight, saved as
   {"model": sd} to a temporary .pth, read back by
   weights.convert.load_torch_checkpoint and converted bit-equal to its
   source; then tools.parity_check --config vitl336 --limit 4 on the
   fixture set must exit 0 and launch every forward kernel.
26. The fork's Ver31 dual-encoder family: eval_preset(fusion_ver31()),
   seeded, bf16, T = 150 on phase 4's two images as a sliding Predictor
   batch (RemoteCLIP ViT-B/32 at 768^2 and DINO ViT-B/8 at 384^2 on each of
   the 10 tiles).  Parameters, seeded-init seconds, device memory; one
   counted run launches LayerNorm, dense attention, the Swin pair and the
   class layer and never the corr embed, the decoder (FusionUP is the
   reference's plain composition), a backward or an unfused stage's
   kernel; the class layer's calls carry no text guidance; every kernel
   call of one probs_sliding_batch is held against its plain version on
   its own inputs at [3]'s bound for its dtype;
   probabilities finite in [0, 1]; images/s, median of 3.
27. fp32 parity of fusion_ver31(compute_dtype="float32"): one whole-image
   forward (probs_whole: the padded image resized to 768^2 and, on its own,
   to 384^2), 20 classes, GPU kernels against the port on the CPU, max
   |d prob| below 5e-4.
28. Ver31 at T = 847 (ADE-full): each cost volume its own top-k to pad_len
   256; finite probabilities, the launches, images/s, as [6].
29. The Ver14 SAM refinement family: eval_preset(fusion_ver14()), seeded,
   bf16, T = 150, sliding, proposals from the raw CLIP cost: SAM ViT-B at
   1024^2 on each tile (image by image), the mask decoder over the classes
   one per image a step.  Launches LayerNorm and dense attention, no
   aggregator kernel; memory, init and images/s as [26].  Then one
   whole-image predict_argmax with refine_from="head" launches the corr
   embed, Swin pair, class layer and decoder kernels.  Every kernel call of
   a sliding batch and of the head variant's predict_argmax (LayerNorm at
   768 in CLIP and SAM and at 256 in the fp32 mask decoder) is held against
   its plain version on its own inputs at [3]'s bound for its dtype.  Then fp32 parity of
   one whole-image raw-corr forward at T = 8 against the CPU port, bound
   5e-4 (the mask decoder's weights x5 and the SAM rel-pos tables redrawn,
   so the refined logits are O(1)).
30. The fusion converter on the card: a seeded Ver31 and a seeded Ver14
   model's state dicts (the fork's key names), saved as {"model": sd} to a
   temporary .pth, read back by weights.convert.load_torch_checkpoint and
   converted bit-equal to their sources; then python -m
   catseg_tpu_torch.tools.eval --config fusion_ver31 --limit 2 on the
   fixture set must exit 0.

Phase [3] also gives each call under 1 ms a device time: 20 calls captured
in one CUDA graph, timed over its replays (no host launch path inside),
rotating over enough copies of the inputs (LayerNorm, dense attention) that
they come from device memory and not from the L2.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and before that a JSON line with one entry
per kernel.
"""

from __future__ import annotations

import copy
import functools
import hashlib
import json
import math
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

PROB_BOUND = 5e-4   # fp32 GPU-vs-CPU max |d prob| (the README's oracle bound)
STAGE_BOUND = {torch.float32: 2e-4, torch.bfloat16: 2.0 ** -5}   # unfused vs fused stage, of max(1, |fused|)
SEED = 0
STEADY_IMAGES = 256   # entries of [19]'s steady-state dataset of 480x640 JPEGs


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings after ``warmup`` calls.  A call
    under 1 ms is timed as one event pair around 20 back-to-back calls,
    divided by 20: in a single call's window the host's launch time (ctypes,
    argument checks) would land inside a short kernel's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    inner, times = 1, []
    while len(times) < reps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / inner
        if inner == 1 and ms < 1.0:
            inner = 20      # the first reading decides; it is not kept
            continue
        times.append(ms)
    return statistics.median(times)


def graph_ms(fns, calls: int = 20, reps: int = 10) -> float:
    """Device time of one call: ``calls`` back-to-back calls, rotating over
    ``fns`` (one call on different copies of its inputs), captured in one
    CUDA graph; the median of ``reps`` CUDA-event timed replays, divided by
    ``calls``.  A replay enqueues no host work, so this is the time the card
    takes, gaps between the kernels included, without the host's launch
    path (autograd, casts, the ctypes launch)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def rotation(case) -> tuple[list, list]:
    """(kernel thunks, library thunks) over enough copies of a case's inputs
    that one turn moves at least three times the L2's bytes: in a graph
    replay each call then reads its inputs from device memory, as its byte
    bound assumes, not from the L2 the previous call filled."""
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    n = 1 if case.fresh is None else max(1, math.ceil(3 * l2 / case.bytes))
    pairs = [(case.kernel, case.library)] + [case.fresh() for _ in range(n - 1)]
    return [k for k, _ in pairs], [lib for _, lib in pairs]


def check_kernels(dev, dtype, selfcheck, _build) -> dict:
    """Phase 3 for one dtype: {case: {max_abs_err, rel_err (the judged error: a forward output's
    max relative, a backward's worst relative Frobenius), rel_bound, ms, plain_ms, library_ms,
    bound_ms, bound_by}}.  A case whose kernel call does not raise its kernel's launch count
    fails (case "mlp@swin" counts as "mlp")."""
    out, bad = {}, []
    for name, case in selfcheck.cases(dev, dtype).items():
        got, counts = run_counted(case.kernel, _build)
        if counts[name.split("@")[0]] == 0:
            bad.append(f"{name} (never launched its kernel)")
        want = case.plain()
        torch.cuda.synchronize()
        err, rel = selfcheck.rel_err(got, want)
        # gradients: the Frobenius error is judged; the max-norm one is read
        worst = " max-norm {:.1e} ({})".format(*selfcheck.max_rel(got, want)) if isinstance(want, dict) else ""
        del got, want
        reps = 3 if name.endswith("_bwd") else 10   # a backward call takes up to a second
        k_ms, p_ms = time_ms(case.kernel, reps, 1), time_ms(case.plain, reps, 1)
        lib_ms = time_ms(case.library) if case.library is not None else None
        # under 1 ms the host's launch path may rival the kernel: device time beside it
        dev_ms = lib_dev_ms = None
        if k_ms < 1.0:
            kerns, libs = rotation(case)
            dev_ms = graph_ms(kerns)
            lib_dev_ms = graph_ms(libs) if case.library is not None else None
            del kerns, libs
        b_ms, b_by = selfcheck.bound_ms(case)
        bound = selfcheck.bound(name, dtype)
        lib = "none" if lib_ms is None else f"{lib_ms:.3f} ms (kernel / library {k_ms / lib_ms:.2f})"
        dev = "" if dev_ms is None else f"  device (CUDA graph) kernel {dev_ms:.4f} ms" + (
            "" if lib_dev_ms is None else f" library {lib_dev_ms:.4f} ms (kernel / library {dev_ms / lib_dev_ms:.2f})")
        log(f"  {name:16s} {str(dtype)[6:]:9s} max_abs_err {err:.3e} rel {rel:.3e} (bound {bound:.1e}){worst} "
            f"kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms  library {lib}  bound {b_ms:.4f} ms ({b_by}){dev}")
        if not rel <= bound:
            bad.append(name)
        out[name] = {"max_abs_err": err, "rel_err": rel, "rel_bound": bound, "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "device_ms": dev_ms, "library_device_ms": lib_dev_ms}
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions, or never launched, in {dtype}: {bad}")
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


def synthetic_batch(B: int, T: int, seed: int):
    """B uint8 384^2 crops and int64 targets in [0, T) with ~10% ignore (255)."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, 384, 384, 3), dtype=np.uint8)
    targets = rng.randint(0, T, (B, 384, 384)).astype(np.int64)
    targets[rng.rand(B, 384, 384) < 0.1] = 255
    return torch.from_numpy(images), torch.from_numpy(targets)


TRAIN_STEPS = 20   # timed train steps after the warm-up, [8] and [12]


def train_step_phase(dev, smi, _build, cfg, expect, absent) -> dict:
    """Phases 8 and 12: one counted step (every kernel in ``expect`` launched,
    none in ``absent``), TRAIN_STEPS timed steps; returns the counted step's
    launches."""
    from catseg_tpu_torch.configs import class_names
    from catseg_tpu_torch.train.loop import class_tokens, init_train_state, make_train_step

    names = class_names("coco")
    state = init_train_state(cfg, seed=SEED)
    model, opt = state.model, state.optimizer
    step = make_train_step(cfg, opt, class_tokens(names))
    images, targets = (t.to(dev) for t in synthetic_batch(4, len(names), SEED))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, counts = run_counted(lambda: step(model, images, targets), _build)
    log(f"    warm-up step: loss {loss.item():.6f}, launches {counts}")
    if not torch.isfinite(loss) or min(counts[k] for k in expect) == 0 or any(counts[k] for k in absent):
        raise AssertionError("train step: non-finite loss, a kernel of the path never launched, or one "
                             f"of {absent} did")
    steps = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(model, images, targets)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(steps)
    log(f"    {ms:.1f} ms/step median, min {min(steps):.1f}, max {max(steps):.1f} ({TRAIN_STEPS} steps after the "
        f"warm-up), {4e3 / ms:.3f} images/s on {smi}; last loss {loss.item():.6f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    frozen = [n for n, lbl in opt.labels.items() if lbl == "frozen"]
    trainable = [n for n, lbl in opt.labels.items() if lbl != "frozen"]
    params = dict(model.named_parameters())
    changed = [n for n in frozen if not torch.equal(params[n], start[n])]
    moved = sum(not torch.equal(params[n], start[n]) for n in trainable)
    log(f"    {len(frozen)} frozen tensors, {len(changed)} changed; {moved} of {len(trainable)} trainable moved")
    if changed or moved <= 0.9 * len(trainable):
        raise AssertionError(f"train step: frozen changed {changed[:5]} or too few trainables moved")
    del state, model, opt, start, params
    torch.cuda.empty_cache()
    return counts


def train_parity_phase(dev) -> None:
    """Phase 9: fp32 step on the card (kernels) against the port on the CPU."""
    from catseg_tpu_torch.configs import class_names, vitb384
    from catseg_tpu_torch.core.clip import truncate_context
    from catseg_tpu_torch.train.loop import TrainState, class_tokens, init_train_state, train_loss
    from catseg_tpu_torch.train.optim import TrainOptimizer

    log("[9] fp32 train-step parity: vitb384(compute_dtype='float32'), 1 crop, 8 classes, GPU vs CPU")
    cfg = vitb384(compute_dtype="float32")
    cpu = init_train_state(cfg, seed=SEED, device="cpu")
    gpu_model = copy.deepcopy(cpu.model).to(dev)
    gpu = TrainState(model=gpu_model, optimizer=TrainOptimizer(cfg, gpu_model))
    tokens = torch.from_numpy(truncate_context(class_tokens(class_names("coco")[:8])).astype(np.int64))
    images, targets = synthetic_batch(1, 8, SEED + 3)
    start = {n: p.detach().clone() for n, p in cpu.model.named_parameters()}
    loss_g = train_loss(cfg, gpu.model, tokens.to(dev), images.to(dev), targets.to(dev))
    loss_g.backward()
    loss_c = train_loss(cfg, cpu.model, tokens, images, targets)
    loss_c.backward()
    d_loss = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    worst, worst_name, unused, symmetric = 0.0, None, [], 0.0
    gp = dict(gpu.model.named_parameters())
    for n, p in cpu.model.named_parameters():
        if not p.requires_grad:
            continue
        g_cpu, g_gpu = p.grad, gp[n].grad
        if g_cpu is None and g_gpu is None:
            unused.append(n)   # the last visual block's q / k: its dense output uses only v
            continue
        if g_cpu is None or g_gpu is None:
            raise AssertionError(f"no gradient for {n} on the {'CPU' if g_cpu is None else 'GPU'}")
        if ".swin_block." in n and n.endswith(".attn.k.bias"):
            # zero by symmetry (softmax ignores a per-query constant): both hold rounding noise
            symmetric = max(symmetric, g_cpu.abs().max().item(), g_gpu.abs().max().item())
            continue
        r = (g_gpu.cpu() - g_cpu).abs().max().item() / max(g_cpu.abs().max().item(), 1e-30)
        if r > worst:
            worst, worst_name = r, n
    log(f"    loss GPU {loss_g.item():.8f} CPU {loss_c.item():.8f} (rel {d_loss:.2e}, bound 1e-5); "
        f"worst gradient max|d|/max|g_cpu| {worst:.2e} at {worst_name} (bound 1e-3); "
        f"no gradient on either side: {unused}; swin k-bias gradients (zero by symmetry) at most {symmetric:.1e}")
    gpu.optimizer.step()
    cpu.optimizer.step()
    upd, frozen_ok, moved, n_train = 0.0, True, 0, 0
    for n, p in cpu.model.named_parameters():
        q = gp[n].detach().cpu()
        if cpu.optimizer.labels[n] == "frozen":
            frozen_ok &= torch.equal(p, start[n]) and torch.equal(q, start[n])
            continue
        if n in unused:
            continue
        n_train += 1
        moved += int(not torch.equal(p, start[n]) and not torch.equal(q, start[n]))
        upd = max(upd, ((q - start[n]) - (p.detach() - start[n])).abs().max().item())
    log(f"    after one update: frozen equal {frozen_ok}, {moved} of {n_train} trainables with a gradient "
        f"moved on both, largest update difference {upd:.3e}")
    if not d_loss <= 1e-5 or not worst <= 1e-3 or not frozen_ok or moved <= 0.9 * n_train:
        raise AssertionError("fp32 train step on the GPU disagrees with the CPU port")
    del cpu, gpu, gpu_model
    torch.cuda.empty_cache()


def full_attention_serving_phase(dev, smi, _build, images, hws, canvas, names):
    """Phase 10; returns the counted run's launches and the model's aggregator."""
    from catseg_tpu_torch.configs import eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.infer.pipeline import Predictor

    log("[10] sliding-window Predictor, eval_preset(vitb384(attention_type='full')), bf16, T=150")
    cfg = eval_preset(vitb384(attention_type="full"))
    pred = Predictor(build_catseg(cfg, seed=SEED), cfg, names)
    pred.preds_sliding_batch(images, hws, canvas)
    preds, launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run: {launches}")
    if (launches["mlp"] == 0 or launches["class_layer"] or launches["window_attention"]
            or launches["linear_attention"] or not all(launches[k] for k in ("swin_block", "decoder"))):
        raise AssertionError("full attention: the class MLP kernel never launched, or the route is wrong")
    check_preds(preds, canvas, len(names))
    check_probs(pred.probs_sliding_batch(images), len(names))
    ips, med = images_per_s(pred, images, hws, canvas)
    log(f"    {ips:.3f} images/s with full class attention (median of 3 2-image runs, {med * 1e3:.1f} ms) on "
        f"{smi}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    agg = pred.model.agg
    del pred
    torch.cuda.empty_cache()
    return launches, agg


def full_parity_phase(images, names) -> None:
    """Phase 11: fp32 full-attention slice on the card against the CPU port."""
    from catseg_tpu_torch.configs import eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
    from catseg_tpu_torch.infer.pipeline import Predictor

    log("[11] fp32 parity with attention_type='full': GPU kernels vs the port on the CPU, 1 image, 20 classes")
    cfg = eval_preset(vitb384(compute_dtype="float32", attention_type="full"))
    cpu_model = init_catseg_(CATSeg(cfg), SEED).eval()
    gpu_pred = Predictor(copy.deepcopy(cpu_model), cfg, names[:20])
    p_gpu = gpu_pred.probs_sliding_batch(images[1:]).cpu()
    p_cpu = Predictor(cpu_model, cfg, names[:20], device="cpu").probs_sliding_batch(images[1:])
    d = (p_gpu - p_cpu).abs()
    log(f"    max|d prob| {d.max().item():.3e} (bound {PROB_BOUND:.0e})  mean {d.mean().item():.3e}")
    if not d.max().item() < PROB_BOUND:
        raise AssertionError("fp32 full-attention slice on the GPU disagrees with the CPU port")
    del gpu_pred, cpu_model
    torch.cuda.empty_cache()


def stage_phase(dev, agg, _build) -> dict:
    """Phase 13: the unfused stages against the fused kernels at full width;
    returns the launches of the bf16 unfused runs."""
    from catseg_tpu_torch.configs import eval_preset, vitb384
    from catseg_tpu_torch.core import aggregator as A
    from catseg_tpu_torch.kernels import selfcheck

    log("[13] unfused stages vs the fused kernels: Swin pair on (10, 150, 24, 24, 128) with guidance; "
        "linear class stage at T=150 (pad 256, pooling 1x1) and (4, 171) pooling 2x2")
    serve, train = eval_preset(vitb384()), vitb384()
    layer = agg.layers[0]
    g = torch.Generator().manual_seed(SEED + 4)
    xs, gs = torch.randn(10, 150, 24, 24, 128, generator=g), torch.randn(10, 24, 24, 128, generator=g) * 0.5
    ts = torch.relu(torch.randn(10, 150, 128, generator=g)) * 0.3
    xt, tt = torch.randn(4, 171, 24, 24, 128, generator=g), torch.relu(torch.randn(4, 171, 128, generator=g)) * 0.3
    total = dict.fromkeys(_build.UNFUSED, 0)
    bad = []
    for dt in (torch.float32, torch.bfloat16):
        x, ag, tg, x2, tg2 = (t.to(dev, dt) for t in (xs, gs, ts, xt, tt))
        stages = {
            "swin pair": (lambda: A.spatial_aggregation(x, ag, layer, serve),
                          lambda: A.swin_pair_unfused(x, ag, layer, serve), ("window_attention", "mlp")),
            "class T=150 1x1": (lambda: A.class_aggregation(x, tg, layer, serve),
                                lambda: A.class_layer_unfused(x, tg, layer, serve), ("linear_attention", "mlp")),
            "class T=171 2x2": (lambda: A.class_aggregation(x2, tg2, layer, train),
                                lambda: A.class_layer_unfused(x2, tg2, layer, train), ("linear_attention", "mlp")),
        }
        with torch.no_grad():
            for name, (fused, unfused, kernels) in stages.items():
                want = fused()
                got, counts = run_counted(unfused, _build)
                err, rel = selfcheck.rel_err(got, want)
                del got, want
                ms_f, ms_u = time_ms(fused, 3, 1), time_ms(unfused, 3, 1)
                log(f"    {name:16s} {str(dt)[6:]:9s} max_abs_err {err:.3e} rel {rel:.3e} "
                    f"(bound {STAGE_BOUND[dt]:.1e})  fused {ms_f:.3f} ms  unfused {ms_u:.3f} ms  "
                    f"launches {({k: counts[k] for k in _build.UNFUSED})}")
                if not rel <= STAGE_BOUND[dt] or min(counts[k] for k in kernels) == 0:
                    bad.append((name, str(dt)))
                if dt == torch.bfloat16:
                    for k in _build.UNFUSED:
                        total[k] += counts[k]
                torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"unfused stages disagree with the fused kernels or skipped a kernel: {bad}")
    return total


WHOLE_RUNS = 20   # timed 2-image runs of [15]


def whole_image_phase(smi, _build, images, names) -> dict:
    """Phase 15; returns the counted run's launches."""
    from catseg_tpu_torch.configs import vitb384
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.kernels import selfcheck

    log("[15] single-image API, whole-image branch: Predictor(vitb384()) (bf16, pooling 2x2), T=150, predict_argmax")
    cfg = vitb384()
    pred = Predictor(build_catseg(cfg, seed=SEED), cfg, names)

    def run():
        return [pred.predict_argmax(im) for im in images]

    run()                                                  # warm-up (cuDNN plans)
    labels, launches = run_counted(run, _build)
    log(f"    launches in one 2-image run: {launches}")
    missing = [k for k in _build.FORWARD if launches[k] == 0]
    if missing or any(launches[k] for k in _build.BACKWARD + _build.UNFUSED):
        raise AssertionError(f"the whole-image path never launched {missing}, or launched a backward or an "
                             "unfused stage's kernel")
    for im, lab in zip(images, labels):
        if lab.shape != im.shape[:2] or lab.dtype != np.int32 or lab.min() < 0 or lab.max() >= len(names):
            raise AssertionError(f"labels {lab.shape} {lab.dtype} in [{lab.min()}, {lab.max()}]")
    # each forward kernel on the very inputs this path hands it (class layer
    # on the 12x12 pooled grid outside autograd, the decoder at 150 slabs)
    with selfcheck.recorded_calls() as calls:
        probs = pred.probs_whole(images[0])
    shapes = {}
    for name, args in calls:
        shapes.setdefault(name, tuple(args[0].shape))
    errs = selfcheck.check_calls(calls, torch.bfloat16)
    bad = sorted(set(_build.FORWARD) - set(errs))
    for name, (n, err, rel) in errs.items():
        bound = selfcheck.bound(name, torch.bfloat16)
        log(f"    {name:16s} bf16 {n:2d} calls of this path, first input {shapes[name]}: max_abs_err {err:.3e} "
            f"rel {rel:.3e} (bound {bound:.1e})")
        if not rel <= bound:
            bad.append(name)
    del calls
    if bad:
        raise AssertionError(f"on the whole-image path's own inputs these kernels disagree with their plain "
                             f"versions, or were never called: {bad}")
    if probs.shape != (96, 96, len(names)) or probs.dtype != torch.float32 or not (
            (probs >= 0) & (probs <= 1)).all():
        raise AssertionError(f"whole-image probs {tuple(probs.shape)} {probs.dtype} outside [0, 1]")
    secs = []
    for _ in range(WHOLE_RUNS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = statistics.median(secs)
    log(f"    {len(images) / med:.3f} images/s on the whole-image branch at the median of {WHOLE_RUNS} 2-image "
        f"runs ({med * 1e3:.1f} ms; min {min(secs) * 1e3:.1f} ms = {len(images) / min(secs):.3f} images/s, max "
        f"{max(secs) * 1e3:.1f} ms = {len(images) / max(secs):.3f} images/s) on {smi}; labels "
        f"{[lab.shape for lab in labels]} in [{min(lab.min() for lab in labels)}, {max(lab.max() for lab in labels)}], "
        f"{len(np.unique(np.concatenate([lab.ravel() for lab in labels])))} distinct")
    del pred
    torch.cuda.empty_cache()
    return launches


def single_image_parity_phase(_build, image, names, cpu_model, p_cpu_sliding) -> None:
    """Phase 16: the single-image API in fp32 on the card against the CPU
    port; ``cpu_model`` and its sliding probabilities come from phase 5."""
    from catseg_tpu_torch.configs import eval_preset, vitb384
    from catseg_tpu_torch.infer.pipeline import Predictor

    log("[16] fp32 parity of the single-image API: vitb384(compute_dtype='float32'), 1 image, 20 classes, GPU vs CPU")
    cfg = vitb384(compute_dtype="float32")
    gpu = Predictor(copy.deepcopy(cpu_model), cfg, names)
    cpu = Predictor(cpu_model, cfg, names, device="cpu")
    p_gpu, launches = run_counted(lambda: gpu.probs_whole(image).cpu(), _build)
    p_cpu = cpu.probs_whole(image)
    d = (p_gpu - p_cpu).abs()
    agree = (gpu.predict_argmax(image) == cpu.predict_argmax(image)).mean()
    gpu_s = Predictor(gpu.model, eval_preset(cfg), names)
    s_gpu = gpu_s.probs_sliding(image)
    row_equal = torch.equal(s_gpu, gpu_s.probs_sliding_batch([image])[0])
    ds = (s_gpu.cpu() - p_cpu_sliding).abs()
    log(f"    probs_whole max|d prob| {d.max().item():.3e} (bound {PROB_BOUND:.0e})  mean {d.mean().item():.3e}  "
        f"launches {launches}")
    log(f"    predict_argmax agreement {agree:.5f} (bound 0.999); probs_sliding (eval_preset) max|d prob| "
        f"{ds.max().item():.3e} (bound {PROB_BOUND:.0e}) mean {ds.mean().item():.3e}; equal to the batch row {row_equal}")
    if (not d.max().item() < PROB_BOUND or not agree >= 0.999 or not ds.max().item() < PROB_BOUND or not row_equal
            or min(launches[k] for k in _build.FORWARD) == 0):
        raise AssertionError("the fp32 single-image API on the GPU disagrees with the CPU port, or skipped a kernel")
    del gpu, gpu_s
    torch.cuda.empty_cache()


def routes_phase(dev, _build) -> None:
    """Phase 17: the aggregator at geometries some kernels do not take."""
    from catseg_tpu_torch.core.aggregator import aggregator_forward
    from catseg_tpu_torch.kernels import selfcheck

    log("[17] aggregator routes outside some kernels' limits: fp32, T=8, GPU vs CPU, or the card's refusal")
    bad = []
    for name, route in selfcheck.ROUTES.items():
        called, refused = route[-2:]
        cfg, agg, (img, txt, guid) = selfcheck.route_aggregator(name)
        head = f"    {name:20s} (hidden {cfg.hidden_dim}, {cfg.num_heads} heads, E {img.shape[-1]}):"
        with torch.no_grad():
            want = torch.sigmoid(aggregator_forward(agg, img, txt, guid, cfg))
            agg.to(dev)
            try:
                got, launches = run_counted(lambda: torch.sigmoid(aggregator_forward(
                    agg, img.to(dev), txt.to(dev), tuple(g.to(dev) for g in guid), cfg)).cpu(), _build)
            except NotImplementedError as e:
                log(f"{head} raised, as {sorted(refused)} refuse it: {e}")
                if not any(k.replace("_", " ") in str(e) for k in refused):
                    bad.append(name)
                continue
        d = (got - want).abs().max().item()
        launched = {k for k, n in launches.items() if n}
        log(f"{head} max|d prob| {d:.3e} (bound {PROB_BOUND:.0e})  launched {sorted(launched)}")
        if refused or not d < PROB_BOUND or launched - {"layer_norm"} != called:
            bad.append(name)
    if bad:
        raise AssertionError(f"aggregator routes disagree with the CPU, launched the wrong kernels, or did not "
                             f"raise where a kernel refuses the geometry: {bad}")


def bf16_gate_phase(_build) -> None:
    """Phase 14: the bf16 serving path against fp32 on the card, held to the
    reference's own bounds for its production dtype (tools/bf16_gate.py)."""
    from catseg_tpu_torch.tools import bf16_gate as gate

    log(f"[14] bf16 vs fp32 end to end: eval_preset(vitb384(compute_dtype=dt)), seed {gate.GATE_SEED}, T=150 "
        "random unit text features, one 427x640 image")
    r = gate.readings()
    log(f"    max|d prob| {r['max_abs_dprob']:.4e} (bound {gate.BOUND_MAX:.0e})  mean {r['mean_abs_dprob']:.4e} "
        f"(bound {gate.BOUND_MEAN:.0e})  argmax agreement {r['decided_agreement']:.5f} on {r['decided_pixels']} of "
        f"{r['pixels']} pixels whose fp32 top-2 gap exceeds {gate.DECIDED_GAP} (bound {gate.BOUND_AGREE}; all "
        f"pixels {r['all_agreement']:.5f})  bf16 launches {r['bf16_launches']}")
    missing = [k for k in _build.FORWARD if r["bf16_launches"][k] == 0]
    if not r["ok"] or missing:
        raise AssertionError(f"bf16 serving drifts past the reference's bounds from fp32, or never launched {missing}")


FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_fixtures"


def sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def write_png_grey(path: Path, arr: np.ndarray) -> None:
    """An 8-bit greyscale PNG, filter 0 on every row (the card's machine has
    no imaging library to write a label map with)."""
    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    h, w = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.astype(np.uint8)], 1).tobytes()
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def photo_dataset(tmp: str, n: int) -> str:
    """An ADE-150-layout dataset of n entries under tmp, each the committed
    480x640 4:2:0 JPEG beside one 480x640 PNG label map (classes in
    [0, 150), a band of 255): inputs of a real dataset's size, enough of them
    for a steady rate."""
    from catseg_tpu_torch.data import loader

    root = Path(tmp)
    img_dir = root / "ADEChallengeData2016/images/validation"
    gt_dir = root / "ADEChallengeData2016/annotations_detectron2/validation"
    img_dir.mkdir(parents=True)
    gt_dir.mkdir(parents=True)
    y, x = np.mgrid[0:480, 0:640]
    gt = (y // 24 * 11 + x // 40) % 150
    gt[200:232] = 255
    write_png_grey(root / "gt.png", gt)
    if not np.array_equal(loader.load_gt(str(root / "gt.png")), gt):
        raise AssertionError("the steady-state label map does not read back")
    for i in range(n):
        (img_dir / f"photo_{i:04d}.jpg").symlink_to(FIXTURES / "images/photo_420.jpg")
        (gt_dir / f"photo_{i:04d}.png").symlink_to(root / "gt.png")
    return str(root)


def predictor_ips(pred, items, canvas, batch: int = 2, passes: int = 3) -> float:
    """images/s of Predictor.preds_sliding_batch alone over loaded (image, gt)
    items, ``batch`` at a time as the harness feeds it: median of passes."""
    secs = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(0, len(items), batch):
            chunk = items[i:i + batch]
            pred.preds_sliding_batch([im for im, _ in chunk], np.array([g.shape for _, g in chunk], np.int32), canvas)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    return len(items) / statistics.median(secs)


def host_data_phase(smi) -> dict:
    """Phase 18: the host library built here, every committed fixture
    decoded and resized to its digest; decode and resize times."""
    from catseg_tpu_torch.data import image_io, loader, resize

    t0 = time.perf_counter()
    lib = image_io.build_host()
    log(f"[18] host data: library built in {time.perf_counter() - t0:.2f} s -> {lib}")
    digests = json.loads((FIXTURES / "digests.json").read_text())
    bad = []
    for rel, want in digests["files"].items():
        p = str(FIXTURES / rel)
        if sha256(loader.load_image(p)) != want["rgb"] or sha256(loader.load_gt(p)) != want["gt"]:
            bad.append(rel)
    rel, (short, max_size) = digests["resize"]["file"], digests["resize"]["short_max"]
    img = loader.load_image(str(FIXTURES / rel))
    resized = loader.resize_shortest_edge(img, short, max_size)
    if sha256(resized) != digests["resize"]["sha256"]:
        bad.append(f"resize_shortest_edge({rel}, {short}, {max_size})")
    if not np.array_equal(resize.resize_bilinear_u8_numpy(img, resized.shape[:2]), resized):
        bad.append("C++ resize != its numpy specification")

    def med_ms(fn, n=10):
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t)
        return statistics.median(ts) * 1e3

    r = {"decode_ms": med_ms(lambda: loader.load_image(str(FIXTURES / rel))),
         "resize_ms": med_ms(lambda: loader.resize_shortest_edge(img, short, max_size)),
         "resize_numpy_ms": med_ms(lambda: resize.resize_bilinear_u8_numpy(img, resized.shape[:2]), 3)}
    log(f"    {len(digests['files'])} fixtures + 1 resize against their digests: "
        f"{'all equal' if not bad else 'MISMATCH ' + str(bad)}")
    log(f"    {rel} ({img.shape[0]}x{img.shape[1]}): decode {r['decode_ms']:.3f} ms, resize to "
        f"{resized.shape[0]}x{resized.shape[1]} {r['resize_ms']:.3f} ms (numpy specification "
        f"{r['resize_numpy_ms']:.3f} ms), median of 10 (3), host CPU; card {smi}")
    if bad:
        raise AssertionError(f"the port's decode / resize differs from the committed digests: {bad}")
    return r


def eval_cli_phase(smi, _build, ips_predictor) -> None:
    """Phase 19: tools.eval on the committed 4-image ADE-150 fixture set; then
    the harness's steady rate over STEADY_IMAGES 480x640 JPEGs beside the
    Predictor alone on the same loaded inputs."""
    from catseg_tpu_torch.configs import class_names, eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.data import catalogs, loader
    from catseg_tpu_torch.evaluation import harness
    from catseg_tpu_torch.evaluation.miou import ConfusionAccumulator
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.tools import eval as eval_cli

    root = str(FIXTURES / "dataset")
    log("[19] tools.eval on the fixture dataset (4 images, ADE-150 layout): vitb384, eval preset, bf16, T=150")
    runs = {}
    for b in (2, 1):
        runs[b], launches = run_counted(lambda: eval_cli.main(
            ["--config", "vitb384", "--benchmarks", "ade150", "--data-root", root, "--eval-batch", str(b)])["ade150"],
            _build)
        log(f"    --eval-batch {b}: launches {launches}")
        missing = [k for k in _build.FORWARD if launches[k] == 0]
        if missing:
            raise AssertionError(f"tools.eval never launched {missing}")
    m1, m2 = runs[1], runs[2]
    if m2["num_images"] != 4 or not all(np.isfinite(m2[k]) for k in ("mIoU", "fwIoU", "mACC", "pACC")):
        raise AssertionError(f"tools.eval: {m2['num_images']} images, metrics {m2}")
    same = np.array_equal(m1["_conf"], m2["_conf"]) and all(m1[k] == m2[k] for k in ("mIoU", "fwIoU", "mACC", "pACC"))

    cfg = eval_preset(vitb384())
    spec = catalogs.get_dataset("ade150")
    pairs = loader.list_dataset(spec, root=root)
    items = [(loader.resize_shortest_edge(loader.load_image(i), cfg.min_size_test, cfg.max_size_test),
              loader.load_gt(g)) for i, g in pairs]
    canvas = harness._canvas([g.shape for _, g in items])
    model = build_catseg(cfg, seed=SEED)
    pred = Predictor(model, cfg, class_names("ade150"))
    acc = ConfusionAccumulator(spec.num_classes, spec.ignore_label)
    for i in range(0, len(items), 2):
        chunk = items[i:i + 2]
        hws = np.array([g.shape for _, g in chunk], np.int32)
        preds = pred.preds_sliding_batch([im for im, _ in chunk], hws, canvas)
        gts = torch.full((len(chunk), *canvas), spec.ignore_label, dtype=torch.int32, device=preds.device)
        for j, (_, g) in enumerate(chunk):
            gts[j, :g.shape[0], :g.shape[1]] = torch.from_numpy(g).to(preds.device)
        acc.update(preds, gts)
    direct = np.array_equal(acc.matrix(), m2["_conf"])
    log(f"    mIoU {m2['mIoU']:.4f} fwIoU {m2['fwIoU']:.4f} mACC {m2['mACC']:.4f} pACC {m2['pACC']:.4f} "
        f"(random weights); batch 2 == batch 1 {same}; confusion matrix == Predictor.preds_sliding_batch's {direct}")
    if not same or not direct:
        raise AssertionError("tools.eval's batch 1 and batch 2 differ, or its confusion matrix is not the "
                             "Predictor's")

    ips = sorted(harness.evaluate_benchmark(model, cfg, "ade150", root=root, verbose=False)["images_per_sec"]
                 for _ in range(3))[1]
    log(f"    4 images: harness {ips:.3f} images/s, decode and resize included (median of 3 passes); the Predictor "
        f"alone on the same loaded inputs {predictor_ips(pred, items, canvas):.3f} images/s; [4]'s Predictor "
        f"{ips_predictor:.3f} images/s; on {smi}")

    # the steady state: the 4-image rate above is mostly the pipeline's fill
    def load(pair):   # the harness's own load
        return (loader.resize_shortest_edge(loader.load_image(pair[0]), cfg.min_size_test, cfg.max_size_test),
                loader.load_gt(pair[1]))

    with tempfile.TemporaryDirectory() as tmp:
        big = photo_dataset(tmp, STEADY_IMAGES)
        pairs = loader.list_dataset(spec, root=big)
        t = time.perf_counter()
        items = [load(pair) for pair in pairs]
        load_ms = (time.perf_counter() - t) * 1e3 / len(pairs)
        steady = [harness.evaluate_benchmark(model, cfg, "ade150", root=big, verbose=False) for _ in range(3)]
        if any(r["num_images"] != STEADY_IMAGES or not np.isfinite(r["mIoU"]) for r in steady):
            raise AssertionError(f"the harness over {STEADY_IMAGES} images: {[r['num_images'] for r in steady]}")
        ips = sorted(r["images_per_sec"] for r in steady)[1]
        alone = predictor_ips(pred, items, harness._canvas([g.shape for _, g in items]))
    log(f"    {STEADY_IMAGES} images ({items[0][0].shape[0]}x{items[0][0].shape[1]} after the resize of a 480x640 "
        f"JPEG): harness {ips:.3f} images/s (median of 3 passes), the Predictor alone on the same loaded inputs "
        f"{alone:.3f} images/s, gap {100 * (1 - ips / alone):.1f}%; the harness's load (decode, resize, GT) "
        f"{load_ms:.3f} ms an image in one thread, the Predictor {1e3 / alone:.3f} ms an image; on {smi}")


def tta_phase(smi, _build, names) -> None:
    """Phase 20: TTAPredictor, D2's 9 scales x hflip, and its fp32 parity."""
    from catseg_tpu_torch.configs import eval_preset, vitb384
    from catseg_tpu_torch.core.catseg import CATSeg, build_catseg, init_catseg_
    from catseg_tpu_torch.data import loader
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.infer.tta import TTAPredictor

    image = loader.load_image(str(FIXTURES / "images/photo_420.jpg"))
    log(f"[20] TTAPredictor, D2's 9 scales (400..1200, max 4000) x hflip, on one {image.shape[0]}x{image.shape[1]} "
        "fixture image: vitb384 eval preset, bf16, T=150")
    cfg = eval_preset(vitb384())
    pred = Predictor(build_catseg(cfg, seed=SEED), cfg, names)
    passes = []
    real = pred.probs_sliding_batch
    pred.probs_sliding_batch = lambda images: (passes.append(len(images)), real(images))[1]
    tta = TTAPredictor(pred)
    tta.probs(image)
    torch.cuda.synchronize()
    passes.clear()
    secs = []
    for _ in range(3):
        t = time.perf_counter()
        (p, launches) = run_counted(lambda: tta.probs(image), _build)
        secs.append(time.perf_counter() - t)
    ok = (p.shape == (640, 640, len(names)) and bool(torch.isfinite(p.float()).all())
          and 0 <= p.min().item() and p.max().item() <= 1)
    log(f"    {sum(passes) // 3} passes an image in {len(passes) // 3} calls; probs {tuple(p.shape)} finite in [0, 1] "
        f"{ok}; {statistics.median(secs) * 1e3:.1f} ms an image (median of 3, resizes included) on {smi}; "
        f"launches {launches}")
    if sum(passes) != 3 * 18 or not ok or any(launches[k] == 0 for k in _build.FORWARD):
        raise AssertionError("TTA did not run 18 passes, gave probabilities outside [0, 1], or skipped a kernel")
    del pred, tta

    cfg32 = eval_preset(vitb384(compute_dtype="float32"))
    cpu_model = init_catseg_(CATSeg(cfg32), SEED).eval()
    gpu = TTAPredictor(Predictor(copy.deepcopy(cpu_model), cfg32, names[:20]), min_sizes=(400,))
    cpu = TTAPredictor(Predictor(cpu_model, cfg32, names[:20], device="cpu"), min_sizes=(400,))
    d = (gpu.probs(image).cpu() - cpu.probs(image)).abs()
    log(f"    fp32, scale 400 x hflip, 20 classes: GPU vs the port on the CPU max|d prob| {d.max().item():.3e} "
        f"(bound {PROB_BOUND:.0e})")
    if not d.max().item() < PROB_BOUND:
        raise AssertionError("fp32 TTA on the card disagrees with the CPU port")


def train_cli_phase(smi, _build) -> None:
    """Phase 21: tools.train for 3 steps through the mapper, then tools.eval
    of its checkpoint."""
    from catseg_tpu_torch.configs import vitb384
    from catseg_tpu_torch.data import catalogs, loader, mapper
    from catseg_tpu_torch.tools import eval as eval_cli
    from catseg_tpu_torch.tools import train as train_cli
    from catseg_tpu_torch.train import loop

    root = str(FIXTURES / "dataset")
    cfg = vitb384()
    log("[21] tools.train: vitb384 (bf16, pooling 2x2), B=4, 3 steps on the fixture dataset through the mapper "
        "(ADE-150 names), then tools.eval of its model_final.pth")
    with tempfile.TemporaryDirectory() as tmp:
        pairs = loader.list_dataset(catalogs.get_dataset("ade150"), root=photo_dataset(tmp, 16))
        batches = mapper.train_batches(pairs, cfg.batch_size, np.random.default_rng(SEED), crop_size=cfg.crop_size,
                                       color_aug=cfg.color_aug, ignore=cfg.ignore_value)
        next(batches)
        secs = []
        for _ in range(10):
            t = time.perf_counter()
            next(batches)
            secs.append(time.perf_counter() - t)
    with tempfile.TemporaryDirectory() as out:
        real_train = train_cli.train
        train_cli.train = functools.partial(loop.train, log_every=1)   # a metrics.json line every step
        try:
            state, launches = run_counted(lambda: train_cli.main(
                ["--config", "vitb384", "--dataset", "ade20k_150_test_sem_seg", "--data-root", root, "--output",
                 out, "--steps", "3"]), _build)
        finally:
            train_cli.train = real_train
        with open(Path(out) / "metrics.json") as f:
            losses = [json.loads(line)["loss_sem_seg"] for line in f if "loss_sem_seg" in line]
        final = Path(out) / "model_final.pth"
        log(f"    step {state.step}, losses {[round(x, 5) for x in losses]}, model_final.pth {final.exists()}; "
            f"host {statistics.median(secs) * 1e3:.1f} ms a batch of 4 (the mapper on 480x640 JPEGs, median of 10) "
            f"on {smi}; "
            f"launches {launches}")
        missing = [k for k in _build.FORWARD + _build.BACKWARD if launches[k] == 0]
        if state.step != 3 or len(losses) != 3 or not all(math.isfinite(x) for x in losses) or not final.exists() \
                or missing:
            raise AssertionError(f"tools.train: step {state.step}, losses {losses}, never launched {missing}")
        del state
        torch.cuda.empty_cache()
        m = eval_cli.main(["--config", "vitb384", "--checkpoint", str(final), "--benchmarks", "ade150",
                           "--data-root", root])["ade150"]
    log(f"    tools.eval --checkpoint model_final.pth: {m['num_images']} images, mIoU {m['mIoU']:.4f}")
    if m["num_images"] != 4 or not np.isfinite(m["mIoU"]):
        raise AssertionError("tools.eval of the trained checkpoint failed")


TIER_PRESETS = ("vitl336", "vith336", "vitg336")


def memory_line() -> str:
    from catseg_tpu_torch.utils.profiling import device_memory_stats

    m = device_memory_stats()["cuda:0"]
    return (f"memory in use {m['bytes_in_use'] / 2**30:.2f} GiB, peak {m['peak_bytes_in_use'] / 2**30:.2f} GiB of "
            f"{m['bytes_limit'] / 2**30:.2f} GiB")


def tier_serving_phase(smi, _build, images, hws, canvas, names) -> None:
    """Phase 22: the larger encoder tiers at full width and depth, seeded
    random weights, eval_preset, bf16, T = 150; for vitl336 also the T = 459
    top-k batch and one whole-image predict_argmax."""
    from catseg_tpu_torch import configs
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.infer.pipeline import Predictor

    for preset in TIER_PRESETS:
        cfg = configs.eval_preset(getattr(configs, preset)())
        v = cfg.clip
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_catseg(cfg, seed=SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        log(f"[22] {preset}: {v.name} ({v.layers} layers, width {v.width}, {v.heads} heads of "
            f"{v.width // v.heads}, MLP {v.mlp_width}, {v.act}; text width {v.text_width}), {n_params / 1e6:.1f} M "
            f"parameters, seeded init + copy to the card {init_s:.1f} s; {memory_line()}")
        pred = Predictor(model, cfg, names)
        pred.preds_sliding_batch(images, hws, canvas)                    # warm-up
        preds, launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
        expect = [k for k in _build.FORWARD if k != "dense_attention" or v.width // v.heads == 64]
        log(f"    launches in one 2-image run (T=150): {launches}")
        if (any(launches[k] == 0 for k in expect) or any(launches[k] for k in _build.UNFUSED + _build.BACKWARD)
                or (launches["dense_attention"] > 0) != ("dense_attention" in expect)):
            raise AssertionError(f"{preset}: a kernel of {expect} never launched, or another one did")
        check_preds(preds, canvas, len(names))
        check_probs(pred.probs_sliding_batch(images), len(names))
        ips, med = images_per_s(pred, images, hws, canvas)
        log(f"    {ips:.3f} images/s (median of 3 2-image runs, {med * 1e3:.1f} ms) on {smi}; {memory_line()}")
        if preset == "vitl336":
            names459 = configs.class_names("pc459")
            pred = Predictor(model, cfg, names459)
            pred.preds_sliding_batch(images, hws, canvas)
            preds459, topk = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
            if topk["class_layer"] == 0 or topk["decoder"] == 0 or any(topk[k] for k in _build.UNFUSED):
                raise AssertionError("vitl336 T=459: the class-layer or decoder kernel never launched, or an "
                                     "unfused stage's did")
            check_preds(preds459, canvas, len(names459))
            ips459, med459 = images_per_s(pred, images, hws, canvas)
            log(f"    T=459 (PC-459, top-k to pad_len 256): {ips459:.3f} images/s ({med459 * 1e3:.1f} ms); launches "
                f"{topk}")
            whole = configs.vitl336()
            pred = Predictor(model, whole, names)
            pred.predict_argmax(images[0])
            t = time.perf_counter()
            labels, wl = run_counted(lambda: pred.predict_argmax(images[0]), _build)
            whole_ms = (time.perf_counter() - t) * 1e3
            if (labels.shape != images[0].shape[:2] or labels.min() < 0 or labels.max() >= len(names)
                    or any(wl[k] == 0 for k in _build.FORWARD)):
                raise AssertionError(f"vitl336 whole image: labels {labels.shape}, launches {wl}")
            log(f"    whole-image predict_argmax ({images[0].shape[0]}x{images[0].shape[1]} zero-padded to "
                f"768x768, resized to {whole.clip_resolution}^2, pooling 2x2): {whole_ms:.1f} ms with the launch "
                f"count; launches {wl}")
        del pred, model
        torch.cuda.empty_cache()
        log(f"    freed: {memory_line()}")


def tier_parity_phase(image, names) -> None:
    """Phase 23: fp32 vitl336, one whole-image forward on the card against
    the port on the CPU, 20 classes."""
    from catseg_tpu_torch.configs import vitl336
    from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
    from catseg_tpu_torch.infer.pipeline import Predictor

    log("[23] fp32 parity of vitl336: one whole-image forward, 20 classes, GPU kernels vs the port on the CPU")
    cfg = vitl336(compute_dtype="float32")
    cpu_model = init_catseg_(CATSeg(cfg), SEED).eval()
    gpu = Predictor(copy.deepcopy(cpu_model), cfg, names)
    p_gpu = gpu.probs_whole(image).cpu()
    t = time.perf_counter()
    p_cpu = Predictor(cpu_model, cfg, names, device="cpu").probs_whole(image)
    d = (p_gpu - p_cpu).abs()
    log(f"    probs {tuple(p_gpu.shape)}: max|d prob| {d.max().item():.3e} (bound {PROB_BOUND:.0e})  mean "
        f"{d.mean().item():.3e}; the CPU's forward {time.perf_counter() - t:.1f} s")
    if not d.max().item() < PROB_BOUND:
        raise AssertionError("fp32 vitl336 on the GPU disagrees with the CPU port")
    del gpu, cpu_model
    torch.cuda.empty_cache()


def fused_qkv_checkpoint(sd: dict) -> dict:
    """A state dict with each CLIP attention's q / k / v weights fused into
    one ``in_proj_weight``, as the OpenAI and open_clip files hold them."""
    out = dict(sd)
    for k in [k for k in sd if k.endswith("attn.q_proj_weight")]:
        stem = k[:-len("q_proj_weight")]
        out[stem + "in_proj_weight"] = torch.cat([out.pop(f"{stem}{n}_proj_weight") for n in "qkv"])
    return out


def converter_phase(smi, _build) -> None:
    """Phase 25: a synthetic fused-qkv vitl336 checkpoint through the
    converter and tools.parity_check --limit on the fixture set."""
    from catseg_tpu_torch.configs import vitl336
    from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
    from catseg_tpu_torch.tools import parity_check
    from catseg_tpu_torch.weights import convert

    log("[25] a released-format vitl336 checkpoint (qkv fused, {'model': sd}) through tools.parity_check --limit 4 "
        "on the fixture set (ADE-150 layout)")
    sd = init_catseg_(CATSeg(vitl336()), SEED + 5).state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "model_large.pth")
        torch.save({"model": fused_qkv_checkpoint(sd)}, path)
        t = time.perf_counter()
        back = convert.convert_catseg_checkpoint(convert.load_torch_checkpoint(path), vitl336().num_layers)
        same = set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())
        log(f"    {Path(path).stat().st_size / 2**30:.2f} GiB file; read and converted in "
            f"{time.perf_counter() - t:.1f} s; bit-equal to the model it came from {same}")
        del back
        rc, launches = run_counted(lambda: parity_check.main(
            ["--config", "vitl336", "--checkpoint", path, "--benchmarks", "ade150", "--data-root",
             str(FIXTURES / "dataset"), "--limit", "4"]), _build)
    log(f"    parity_check exit code {rc}; launches {launches}; on {smi}")
    if not same or rc != 0 or any(launches[k] == 0 for k in _build.FORWARD):
        raise AssertionError("the converted checkpoint differs from its source, parity_check failed, or it never "
                             "launched a kernel of the path")
    torch.cuda.empty_cache()


def build_timed(cfg):
    """(model on the card, seeded-init seconds, parameters) after resetting
    the allocator's peak."""
    from catseg_tpu_torch.core.catseg import build_catseg

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_catseg(cfg, seed=SEED)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, sum(p.numel() for p in model.parameters())


def check_launches(launches, expect, absent, what) -> None:
    if any(launches[k] == 0 for k in expect) or any(launches[k] for k in absent):
        raise AssertionError(f"{what}: a kernel of {list(expect)} never launched, or one of {list(absent)} did: "
                             f"{launches}")


def check_path_calls(calls, what: str, expect=()) -> None:
    """Every kernel call recorded on a path (``selfcheck.recorded_calls``)
    against its plain version on the same inputs, at [3]'s bound for the
    call's dtype; fails if one disagrees or a kernel of ``expect`` was never
    called."""
    from catseg_tpu_torch.kernels import selfcheck

    groups = {}
    for name, args in calls:
        groups.setdefault((name, args[0].dtype), []).append((name, args))
    bad = [k for k in expect if not any(name == k for name, _ in groups)]
    for (name, dt), cs in sorted(groups.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        n, err, rel = selfcheck.check_calls(cs, dt)[name]
        bound = selfcheck.bound(name, dt)
        widths = sorted({tuple(a[0].shape)[-1] for _, a in cs})
        log(f"    {name:16s} {str(dt)[6:]:8s} {n:4d} calls of this path, first input {tuple(cs[0][1][0].shape)}, "
            f"last-axis widths {widths}: max_abs_err {err:.3e} rel {rel:.3e} (bound {bound:.1e})")
        if not rel <= bound:
            bad.append(f"{name} {dt}")
    if bad:
        raise AssertionError(f"{what}: on the path's own inputs these kernels disagree with their plain versions, "
                             f"or were never called: {bad}")


# kernels no fusion serving path launches (Ver14's head proposals aside):
# FusionUP and Ver31's embeds are plain compositions, nothing trains
FUSION_ABSENT = ("corr_embed", "decoder", "swin_block_bwd", "class_layer_bwd", "decoder_bwd", "window_attention",
                 "mlp", "linear_attention")


def ver31_serving_phase(smi, _build, images, hws, canvas, names):
    """Phase 26; returns the model for [28]."""
    from catseg_tpu_torch import configs
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.kernels import selfcheck

    cfg = configs.eval_preset(configs.fusion_ver31())
    model, init_s, n_params = build_timed(cfg)
    log(f"[26] Ver31 fusion_ver31(): RemoteCLIP ViT-B/32 at {cfg.fusion.clip_resolution}^2 + DINO ViT-B/8 at "
        f"{cfg.fusion.encoder_resolution}^2, eval preset, bf16, T=150; {n_params / 1e6:.1f} M parameters, seeded init "
        f"+ copy to the card {init_s:.1f} s; {memory_line()}")
    pred = Predictor(model, cfg, names)
    pred.preds_sliding_batch(images, hws, canvas)                          # warm-up
    torch.cuda.reset_peak_memory_stats()
    preds, launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run (10 tiles): {launches}; {memory_line()}")
    check_launches(launches, ("layer_norm", "dense_attention", "swin_block", "class_layer"), FUSION_ABSENT, "Ver31")
    preds = check_preds(preds, canvas, len(names))
    # each kernel on the very inputs this path hands it (#6 without guidance)
    with selfcheck.recorded_calls() as calls:
        probs = pred.probs_sliding_batch(images)
    check_probs(probs, len(names))
    del probs
    guided = sum(args[1] is not None or args[2] is not None for name, args in calls if name == "class_layer")
    log(f"    class layer calls with text guidance: {guided}")
    if guided:
        raise AssertionError("Ver31's class layer took text guidance")
    check_path_calls(calls, "Ver31 sliding", ("layer_norm", "dense_attention", "swin_block", "class_layer"))
    del calls
    ips, med = images_per_s(pred, images, hws, canvas)
    log(f"    {ips:.3f} images/s (median of 3 2-image runs, {med * 1e3:.1f} ms) on {smi}; "
        f"{len(np.unique(preds.numpy()))} distinct labels")
    del pred
    torch.cuda.empty_cache()
    return model


def ver31_parity_phase(image, names) -> None:
    """Phase 27: fp32 Ver31, one whole-image forward, GPU against the CPU port."""
    from catseg_tpu_torch.configs import fusion_ver31
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.infer.pipeline import Predictor

    log("[27] fp32 parity of fusion_ver31(): one whole-image forward, 20 classes, GPU kernels vs the port on the CPU")
    cfg = fusion_ver31(compute_dtype="float32")
    cpu_model = build_catseg(cfg, seed=SEED, device="cpu")
    gpu = Predictor(copy.deepcopy(cpu_model), cfg, names)
    p_gpu = gpu.probs_whole(image).cpu()
    t = time.perf_counter()
    p_cpu = Predictor(cpu_model, cfg, names, device="cpu").probs_whole(image)
    d = (p_gpu - p_cpu).abs()
    log(f"    probs {tuple(p_gpu.shape)} in [{p_gpu.min().item():.4f}, {p_gpu.max().item():.4f}]: max|d prob| "
        f"{d.max().item():.3e} (bound {PROB_BOUND:.0e})  mean {d.mean().item():.3e}; the CPU's forward "
        f"{time.perf_counter() - t:.1f} s")
    if p_gpu.shape != (96, 96, len(names)) or not d.max().item() < PROB_BOUND:
        raise AssertionError("fp32 Ver31 on the GPU disagrees with the CPU port")
    del gpu, cpu_model
    torch.cuda.empty_cache()


def ver31_topk_phase(smi, _build, model, images, hws, canvas) -> None:
    """Phase 28: Ver31 over ADE-847's names."""
    from catseg_tpu_torch import configs
    from catseg_tpu_torch.infer.pipeline import Predictor

    log("[28] Ver31 top-k path: 847 ADE-full names (each volume its own top-k, pad_len 256), bf16")
    names847 = configs.class_names("ade847")
    pred = Predictor(model, model.cfg, names847)
    pred.preds_sliding_batch(images, hws, canvas)
    preds, launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run: {launches}")
    check_launches(launches, ("layer_norm", "dense_attention", "swin_block", "class_layer"), FUSION_ABSENT,
                   "Ver31 T=847")
    check_preds(preds, canvas, len(names847))
    check_probs(pred.probs_sliding_batch(images), len(names847))
    ips, med = images_per_s(pred, images, hws, canvas)
    log(f"    {ips:.3f} images/s at T=847 (median of 3 2-image runs, {med * 1e3:.1f} ms) on {smi}")
    del pred
    torch.cuda.empty_cache()


@torch.no_grad()
def livelier_sam_(model, seed: int):
    """The mask decoder's and prompt encoder's weights x5 and the SAM
    encoder's rel-pos tables drawn N(0, 0.02) from ``seed`` (the seeded
    init leaves them 0), so refined logits are O(1) and the rel-pos terms
    run."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.startswith(("sam_decoder.", "sam_prompt_encoder.mask")) and p.ndim >= 2:
            p.mul_(5.0)
        elif name.startswith("sam_encoder.") and "rel_pos" in name:
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def ver14_phase(smi, _build, images, hws, canvas, names) -> None:
    """Phase 29: Ver14 sliding (raw-corr proposals), the head proposals'
    whole-image path, and fp32 parity."""
    import dataclasses

    from catseg_tpu_torch import configs
    from catseg_tpu_torch.core.catseg import build_catseg
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.kernels import selfcheck

    cfg = configs.eval_preset(configs.fusion_ver14())
    model, init_s, n_params = build_timed(cfg)
    log(f"[29] Ver14 fusion_ver14(): CLIP ViT-B/16 at {cfg.fusion.clip_resolution}^2 + SAM ViT-B at "
        f"{cfg.fusion.encoder_resolution}^2, refine_from={cfg.fusion.refine_from!r}, eval preset, bf16, T=150; "
        f"{n_params / 1e6:.1f} M parameters, seeded init + copy to the card {init_s:.1f} s; {memory_line()}")
    pred = Predictor(model, cfg, names)
    pred.preds_sliding_batch(images, hws, canvas)
    torch.cuda.reset_peak_memory_stats()
    preds, launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run (10 tiles): {launches}; {memory_line()}")
    check_launches(launches, ("layer_norm", "dense_attention"),
                   ("swin_block", "class_layer") + FUSION_ABSENT, "Ver14 raw_corr")
    # every call of that run again, each held against its plain version on
    # its own inputs (#1 at 768 in CLIP and SAM, 256 in the mask decoder)
    with selfcheck.recorded_calls() as calls:
        pred.preds_sliding_batch(images, hws, canvas)
    check_path_calls(calls, "Ver14 raw_corr sliding", ("layer_norm", "dense_attention"))
    del calls
    preds = check_preds(preds, canvas, len(names))
    check_probs(pred.probs_sliding_batch(images), len(names))
    ips, med = images_per_s(pred, images, hws, canvas)
    log(f"    {ips:.3f} images/s (median of 3 2-image runs, {med * 1e3:.1f} ms) on {smi}; "
        f"{len(np.unique(preds.numpy()))} distinct labels")
    del pred, model
    torch.cuda.empty_cache()

    head = configs.fusion_ver14(fusion=dataclasses.replace(cfg.fusion, refine_from="head"))
    pred = Predictor(build_catseg(head, seed=SEED), head, names)
    pred.predict_argmax(images[0])
    t = time.perf_counter()
    labels, wl = run_counted(lambda: pred.predict_argmax(images[0]), _build)
    ms = (time.perf_counter() - t) * 1e3
    log(f"    refine_from='head', whole-image predict_argmax (pooling 2x2): {ms:.1f} ms with the launch count; "
        f"launches {wl}")
    check_launches(wl, _build.FORWARD, _build.BACKWARD + _build.UNFUSED, "Ver14 head")
    if labels.shape != images[0].shape[:2] or labels.min() < 0 or labels.max() >= len(names):
        raise AssertionError(f"Ver14 head labels {labels.shape} in [{labels.min()}, {labels.max()}]")
    with selfcheck.recorded_calls() as calls:
        pred.predict_argmax(images[0])
    check_path_calls(calls, "Ver14 head whole image", _build.FORWARD)
    del calls
    del pred
    torch.cuda.empty_cache()

    cfg32 = configs.fusion_ver14(compute_dtype="float32")
    cpu_model = livelier_sam_(build_catseg(cfg32, seed=SEED, device="cpu"), SEED + 7)
    gpu = Predictor(copy.deepcopy(cpu_model), cfg32, names[:8])
    with torch.inference_mode():
        logits = gpu.model(gpu._image(images[1])[None, :384, :384], gpu.text_feats, cfg32)
    p_gpu = gpu.probs_whole(images[1]).cpu()
    t = time.perf_counter()
    p_cpu = Predictor(cpu_model, cfg32, names[:8], device="cpu").probs_whole(images[1])
    d = (p_gpu - p_cpu).abs()
    log(f"    fp32 raw-corr whole image, T=8: refined logits of a tile in [{logits.min().item():.2f}, "
        f"{logits.max().item():.2f}]; probs {tuple(p_gpu.shape)}: max|d prob| {d.max().item():.3e} (bound "
        f"{PROB_BOUND:.0e})  mean {d.mean().item():.3e}; the CPU's forward {time.perf_counter() - t:.1f} s")
    if p_gpu.shape != (256, 256, 8) or not d.max().item() < PROB_BOUND:
        raise AssertionError("fp32 Ver14 on the GPU disagrees with the CPU port")
    del gpu, cpu_model
    torch.cuda.empty_cache()


def fusion_converter_phase(smi) -> None:
    """Phase 30: seeded Ver31 / Ver14 checkpoints through the converter, then
    tools.eval --config fusion_ver31 in its own process."""
    from catseg_tpu_torch import configs
    from catseg_tpu_torch.core.catseg import init_catseg_, model_class
    from catseg_tpu_torch.weights import convert

    log("[30] fusion checkpoints ({'model': sd}, the fork's key names) through the converter; tools.eval "
        "--config fusion_ver31 --limit 2 on the fixture set")
    with tempfile.TemporaryDirectory() as tmp:
        for preset in ("fusion_ver31", "fusion_ver14"):
            cfg = getattr(configs, preset)()
            sd = init_catseg_(model_class(cfg)(cfg), SEED + 5).state_dict()
            path = str(Path(tmp) / f"{preset}.pth")
            torch.save({"model": sd}, path)
            t = time.perf_counter()
            back = convert.convert_catseg_checkpoint(convert.load_torch_checkpoint(path), cfg.num_layers)
            same = set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())
            log(f"    {preset}: {len(sd)} tensors, {Path(path).stat().st_size / 2**30:.2f} GiB file; read and "
                f"converted in {time.perf_counter() - t:.1f} s; bit-equal to the model it came from {same}")
            if not same:
                raise AssertionError(f"the converted {preset} checkpoint differs from its source")
            del sd, back
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "catseg_tpu_torch.tools.eval", "--config", "fusion_ver31",
                          "--benchmarks", "ade150", "--data-root", str(FIXTURES / "dataset"), "--limit", "2"],
                         capture_output=True, text=True, timeout=600, cwd=Path(__file__).resolve().parent)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("copypaste")]
    log(f"    tools.eval exit code {res.returncode} in {time.perf_counter() - t:.1f} s: {line} on {smi}")
    if res.returncode != 0 or not line:
        raise AssertionError(f"tools.eval --config fusion_ver31 failed: {res.stderr[-2000:]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from catseg_tpu_torch.configs import class_names, eval_preset, vitb384, vitl336
    from catseg_tpu_torch.core.catseg import CATSeg, build_catseg, init_catseg_
    from catseg_tpu_torch.evaluation.miou import ConfusionAccumulator
    from catseg_tpu_torch.infer.pipeline import Predictor
    from catseg_tpu_torch.kernels import _build, selfcheck

    t_start = time.perf_counter()
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
    checks = {dt: check_kernels(dev, dt, selfcheck, _build) for dt in (torch.float32, torch.bfloat16)}
    for name in ("swin_block_bwd", "class_layer_bwd", "decoder_bwd", "mlp", "mlp@swin", "corr_embed",
                 "linear_attention"):   # bf16 on the tensor cores
        c = checks[torch.bfloat16][name]
        what = "worst gradient" if name.endswith("_bwd") else "error"
        log(f"    {name} bf16 (tensor cores): kernel {c['ms']:.3f} ms, plain {c['plain_ms']:.3f} ms, bound "
            f"{c['bound_ms']:.4f} ms, {what} {c['rel_err']:.2e} (bound {c['rel_bound']:.1e})")

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
    missing = [k for k in _build.FORWARD if launches[k] == 0]
    if missing or any(launches[k] for k in _build.UNFUSED):
        raise AssertionError(f"the main path never launched {missing}, or launched an unfused stage's kernel")
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
    if (plain_launches["decoder"] or any(plain_launches[k] for k in _build.UNFUSED)
            or not all(plain_launches[k] for k in _build.FORWARD if k != "decoder")):
        raise AssertionError("the plain-decoder path launched the decoder kernel or an unfused stage's, "
                             "or skipped another one")
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
    if not d.max().item() < PROB_BOUND or min(gpu_launches[k] for k in _build.FORWARD) == 0:
        raise AssertionError("fp32 GPU slice disagrees with the CPU port, or skipped a kernel")
    del gpu_pred
    cpu_model32, p_cpu_sliding = cpu_model, p_cpu[0]      # for phase 16

    log("[6] top-k path: 847 ADE-full names (pad_len 256 kept), bf16, the same 2 images")
    names847 = class_names("ade847")
    pred = Predictor(build_catseg(cfg, seed=SEED), cfg, names847)
    pred.preds_sliding_batch(images, hws, canvas)
    preds847, topk_launches = run_counted(lambda: pred.preds_sliding_batch(images, hws, canvas), _build)
    log(f"    launches in one 2-image run: {topk_launches}")
    if (topk_launches["class_layer"] == 0 or topk_launches["decoder"] == 0
            or any(topk_launches[k] for k in _build.UNFUSED)):
        raise AssertionError("the top-k path skipped the class-layer or decoder kernel, or launched an "
                             "unfused stage's")
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

    log("[8] train step, vitb384() at full width (bf16, pooling 2x2, fused decoder), B=4, T=171, 384^2 crops")
    train_launches = train_step_phase(dev, smi, _build, vitb384(), _build.FORWARD + _build.BACKWARD,
                                      _build.UNFUSED)
    train_parity_phase(dev)

    full_launches, agg = full_attention_serving_phase(dev, smi, _build, images, hws, canvas, names)
    full_parity_phase(images, names)
    log("[12] train step, vitb384(attention_type='full') (bf16, pooling 2x2), B=4, T=171")
    train_step_phase(dev, smi, _build, vitb384(attention_type="full"),
                     [k for k in _build.FORWARD if k != "class_layer"] + ["mlp", "swin_block_bwd", "decoder_bwd"],
                     ("class_layer", "class_layer_bwd", "window_attention", "linear_attention"))
    stage_launches = stage_phase(dev, agg, _build)
    del agg
    torch.cuda.empty_cache()
    bf16_gate_phase(_build)
    whole_image_phase(smi, _build, images, names)
    single_image_parity_phase(_build, images[1], names[:20], cpu_model32, p_cpu_sliding)
    del cpu_model32
    routes_phase(dev, _build)
    host_data_phase(smi)
    eval_cli_phase(smi, _build, ips)
    tta_phase(smi, _build, names)
    train_cli_phase(smi, _build)

    tier_serving_phase(smi, _build, images, hws, canvas, names)
    tier_parity_phase(images[1], names[:20])
    log("[24] train step, vitl336() at full width (bf16, pooling 2x2, fused decoder), B=4, T=171, 384^2 crops")
    train_step_phase(dev, smi, _build, vitl336(), _build.FORWARD + _build.BACKWARD, _build.UNFUSED)
    converter_phase(smi, _build)

    ver31 = ver31_serving_phase(smi, _build, images, hws, canvas, names)
    ver31_parity_phase(images[1], names[:20])
    ver31_topk_phase(smi, _build, ver31, images, hws, canvas)
    del ver31
    torch.cuda.empty_cache()
    ver14_phase(smi, _build, images, hws, canvas, names)
    fusion_converter_phase(smi)

    kernels = []
    for name, route, source, replaces in selfcheck.KERNELS:
        # each kernel's launches in the run of the path that drives it
        n = (full_launches[name] if name == "mlp" else stage_launches[name] if name in _build.UNFUSED
             else launches[name] if name in _build.FORWARD else train_launches[name])
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": n, **checks[torch.bfloat16][name]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
