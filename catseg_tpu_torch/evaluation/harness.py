"""Benchmark evaluation harness: the eval.sh protocol end to end
(catseg_tpu/evaluation/harness.py).

For a (model, benchmark) pair: text features of the benchmark's class JSON,
the validation set streamed through the sliding-window pipeline by a
prefetch thread, argmax maps at each image's true size, the confusion matrix
accumulated on the card, detectron2-identical metrics.

Every image runs at its own size (the port's Predictor has no static input
canvas); the out canvas ``_canvas(sizes)`` stays, as the frame the GT and
``preds_sliding_batch`` are padded to, so every path counts the same pixels.
The tail batch runs at its own size (the JAX package pads it with a
duplicate image to keep XLA's shapes).  Not ported: the mesh-sharded branch
(ROADMAP A6; the port runs on its Predictor's one device and says so when
more GPUs are visible) and ``dump_visuals`` (ROADMAP A7).
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from ..configs import CATSegConfig, eval_preset
from ..core.catseg import CATSeg
from ..data.catalogs import dataset_root, get_dataset, load_class_names
from ..data.loader import Prefetcher, list_dataset, load_gt, load_image, probe_sizes, resize_shortest_edge
from ..infer.pipeline import Predictor, resize_argmax
from .miou import ConfusionAccumulator


def _canvas(sizes, step: int = 256) -> tuple[int, int]:
    hm = max(s[0] for s in sizes)
    wm = max(s[1] for s in sizes)
    return (math.ceil(hm / step) * step, math.ceil(wm / step) * step)


def _finish(acc: ConfusionAccumulator, spec, n: int, t0: float, verbose: bool, tag: str = "") -> dict:
    metrics = acc.metrics()
    metrics["_conf"] = acc.matrix()   # raw confusion matrix (gzero splits etc.)
    metrics["images_per_sec"] = n / (time.time() - t0)
    metrics["num_images"] = n
    if verbose:
        print(f"[{spec.name}]{tag} mIoU {metrics['mIoU']:.2f} fwIoU {metrics['fwIoU']:.2f} "
              f"mACC {metrics['mACC']:.2f} pACC {metrics['pACC']:.2f} "
              f"({metrics['images_per_sec']:.2f} im/s)")
    return metrics


def _evaluate_benchmark_batched(predictor, acc, spec, pairs, load, out_canvas, batch, verbose) -> dict:
    """One model forward (5 tiles an image), the resize-argmax of every
    image, and one confusion update per ``batch`` images."""
    Hc, Wc = out_canvas
    dev = predictor.device
    t0 = time.time()
    n = 0
    buf: list = []

    def flush(items):
        nonlocal n
        hws = np.array([g.shape for _, g in items], np.int32)
        preds = predictor.preds_sliding_batch([im for im, _ in items], hws, (Hc, Wc))
        gt_pads = torch.full((len(items), Hc, Wc), spec.ignore_label, dtype=torch.int32, device=dev)
        for i, (_, gt) in enumerate(items):
            H, W = gt.shape
            gt_pads[i, :H, :W] = torch.from_numpy(gt).to(dev)
        acc.update(preds, gt_pads)
        n += len(items)
        if verbose and (n // batch) % max(1, 100 // batch) == 0:
            print(f"  [{spec.name}] {n}/{len(pairs)} images, {n / (time.time() - t0):.2f} im/s")

    for item in Prefetcher(pairs, load):
        buf.append(item)
        if len(buf) == batch:
            flush(buf)
            buf = []
    if buf:
        flush(buf)
    return _finish(acc, spec, n, t0, verbose, f" (batch {batch})")


def evaluate_benchmark(
    model: CATSeg,
    cfg: CATSegConfig,
    benchmark: str,
    root: str | None = None,
    limit: int | None = None,
    verbose: bool = True,
    sliding: bool = True,
    dump_visuals: int = 0,
    visuals_dir: str = "eval_visuals",
    dump_predictions: str | None = None,
    tta: bool = False,
    eval_batch: int = 2,
) -> dict:
    """Run one eval.sh benchmark on ``model``'s device; returns the metrics
    dict (mIoU, fwIoU, mACC, pACC, per-class IoU / ACC, ``_conf``,
    images_per_sec, num_images).

    sliding=False uses the whole-image branch (the reference's train-time
    eval / demo default, cat_seg_model.py:147-155); tta averages D2's 9
    scales x hflip (SemanticSegmentorWithTTA)."""
    if dump_visuals:
        raise NotImplementedError("dump_visuals needs infer/visualize.py, which is not ported yet (ROADMAP A7)")
    cfg = eval_preset(cfg) if sliding else cfg.replace(sliding_window=False)
    spec = get_dataset(benchmark)
    class_names = load_class_names(spec.class_json)
    pairs = list_dataset(spec, root=root, limit=limit)
    if not pairs:
        raise FileNotFoundError(f"no data for {spec.name} under root {root}")

    def load(pair):
        img = load_image(pair[0])
        gt = load_gt(pair[1])
        return resize_shortest_edge(img, cfg.min_size_test, cfg.max_size_test), gt

    # the GT carries the original size: header-only reads, cached beside the dataset
    cache_path = os.path.join(root or dataset_root(), ".catseg_cache", f"{spec.name}_gt_sizes.json")
    Hc, Wc = _canvas(probe_sizes([g for _, g in pairs], cache_path=cache_path))

    device = next(model.parameters()).device
    if device.type == "cuda" and torch.cuda.device_count() > 1 and verbose:
        print(f"[harness] note: {torch.cuda.device_count()} GPUs visible; the port evaluates on {device} alone "
              "(sharded evaluation waits for ROADMAP A6)", flush=True)
    predictor = Predictor(model, cfg, class_names, device=device)
    if tta:
        from ..infer.tta import TTAPredictor

        predictor = TTAPredictor(predictor)

        # DatasetMapperTTA scales the ORIGINAL image (the wrapper applies
        # ResizeShortestEdge per scale itself): no eval pre-resize
        def load(pair):  # noqa: F811 — intentional TTA override
            return load_image(pair[0]), load_gt(pair[1])

    acc = ConfusionAccumulator(spec.num_classes, spec.ignore_label,
                               clamp_background=spec.evaluator == "sem_seg_background", device=device)
    dumper = None
    if dump_predictions:
        from .coco_dump import PredictionDumper, dataset_id_map

        dumper = PredictionDumper(dump_predictions, id_map=dataset_id_map(spec))

    if sliding and not tta and dumper is None and eval_batch > 1 and len(pairs) > 1:
        return _evaluate_benchmark_batched(predictor, acc, spec, pairs, load, (Hc, Wc), eval_batch, verbose)

    t0 = time.time()
    n = 0
    for img, gt in Prefetcher(pairs, load):
        H, W = gt.shape
        with torch.inference_mode():
            probs = predictor.probs(img)
            pred = torch.zeros((Hc, Wc), dtype=torch.int32, device=device)
            pred[:H, :W] = resize_argmax(probs.permute(2, 0, 1), (H, W))
        gt_pad = torch.full((Hc, Wc), spec.ignore_label, dtype=torch.int32, device=device)
        gt_pad[:H, :W] = torch.from_numpy(gt).to(device)
        acc.update(pred, gt_pad)
        if dumper is not None:
            dumper.add(pred[:H, :W].cpu().numpy(), pairs[n][0])
        n += 1
        if verbose and n % 100 == 0:
            print(f"  [{spec.name}] {n}/{len(pairs)} images, {n / (time.time() - t0):.2f} im/s")
    if dumper is not None:
        dumper.write()
    return _finish(acc, spec, n, t0, verbose)
