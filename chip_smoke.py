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
   (a call under 1 ms timed over 20 back-to-back calls).
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
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PROB_BOUND = 5e-4   # fp32 GPU-vs-CPU max |d prob| (the README's oracle bound)
STAGE_BOUND = {torch.float32: 2e-4, torch.bfloat16: 2.0 ** -5}   # unfused vs fused stage, of max(1, |fused|)
SEED = 0


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
