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
duplicate image to keep XLA's shapes).  ``dump_visuals=N`` writes the first
N images' [image | prediction | GT] strips as
``{visuals_dir}/{benchmark}_{n:04d}.jpg`` (``infer.visualize.save_visual``,
the input bicubic-resized back to the GT's size) from the per-image loop,
as the JAX package does.

Inside a process group of more than one rank (``parallel.mesh``) the
sliding-window benchmark without TTA or dumps runs sharded, under catseg_tpu's
conditions: each rank evaluates its share of the images
(``evaluation.distributed.evaluate_sharded``, the images of other ranks never
decoded) and one ``all_reduce`` sums the matrices, so every rank returns the
same metrics; only rank 0 prints.  A multi-rank run that meets TTA, a dump
or the whole-image branch says that it goes sequential on every rank.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from ..configs import CATSegConfig, eval_preset
from ..core.catseg import CATSeg, compute_dtype
from ..data.catalogs import dataset_root, get_dataset, load_class_names
from ..data.loader import Prefetcher, list_dataset, load_gt, load_image, probe_sizes, resize_shortest_edge
from ..data.resize import resize_bicubic_u8
from ..infer.pipeline import Predictor, resize_argmax
from ..infer.visualize import save_visual
from ..parallel.mesh import make_mesh, rank, world_size
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


def _evaluate_benchmark_sharded(model, cfg, spec, pairs, load, out_canvas, verbose, per_device_batch) -> dict:
    """The rank-sharded loop: this rank's images through the batched
    sliding path, one ``all_reduce`` of the matrix."""
    from ..text.embed import forward_text_embeds
    from .distributed import evaluate_sharded, owner
    from .miou import semseg_metrics

    mesh = make_mesh(devices=[next(model.parameters()).device])
    with torch.inference_mode():
        text_feats = forward_text_embeds(model.clip, load_class_names(spec.class_json), cfg.prompt_ensemble_type,
                                         compute_dtype=compute_dtype(cfg))
    me, n = rank(), mesh.ranks
    # another rank's image is never decoded: its slot carries None
    items = Prefetcher(list(enumerate(pairs)),
                       lambda ip: load(ip[1]) if owner(ip[0], n, per_device_batch) == me else None)
    t0 = time.time()
    cm = evaluate_sharded(model, cfg, mesh, items, text_feats, out_canvas=out_canvas,
                          num_classes=spec.num_classes, ignore=spec.ignore_label,
                          clamp_background=spec.evaluator == "sem_seg_background",
                          per_device_batch=per_device_batch)
    metrics = semseg_metrics(cm)
    metrics["_conf"] = cm
    metrics["num_images"] = len(pairs)
    metrics["images_per_sec"] = len(pairs) / (time.time() - t0)
    if verbose and me == 0:
        print(f"[{spec.name}] ({n}-way sharded) mIoU {metrics['mIoU']:.2f} fwIoU {metrics['fwIoU']:.2f} "
              f"mACC {metrics['mACC']:.2f} pACC {metrics['pACC']:.2f} ({metrics['images_per_sec']:.2f} im/s)")
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

    # the GT carries the original size: header-only reads, cached beside the
    # dataset (written by rank 0 alone)
    cache_path = os.path.join(root or dataset_root(), ".catseg_cache", f"{spec.name}_gt_sizes.json")
    Hc, Wc = _canvas(probe_sizes([g for _, g in pairs], cache_path=cache_path if rank() == 0 else None))
    verbose = verbose and rank() == 0

    device = next(model.parameters()).device
    n_ranks = world_size()
    if sliding and not tta and dump_visuals == 0 and dump_predictions is None and n_ranks > 1:
        return _evaluate_benchmark_sharded(model, cfg, spec, pairs, load, (Hc, Wc), verbose, max(1, eval_batch))
    if n_ranks > 1 and verbose:
        # never fall back silently: a multi-GPU eval quietly going sequential
        # is the failure mode that wastes the big runs
        blockers = [flag for flag, on in [
            ("--tta", tta), ("--dump-visuals", dump_visuals != 0),
            ("--dump-predictions", dump_predictions is not None),
            ("whole-image mode (no sliding)", not sliding)] if on]
        print(f"[harness] WARNING: {n_ranks} ranks, but {', '.join(blockers)} forces the sequential path: every "
              "rank evaluates every image (per-image host-side output)", flush=True)
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

    if sliding and not tta and dump_visuals == 0 and dumper is None and eval_batch > 1 and len(pairs) > 1:
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
        if n < dump_visuals or dumper is not None:
            # pred / GT overlay strips (viz.py TestAndViz, OVRSSS_Visualizer.save_visual)
            pred_np = pred[:H, :W].cpu().numpy()
            if n < dump_visuals:
                os.makedirs(visuals_dir, exist_ok=True)
                save_visual(resize_bicubic_u8(img, (H, W)), pred_np, gt,
                            os.path.join(visuals_dir, f"{spec.name}_{n:04d}.jpg"), spec.num_classes, spec.ignore_label)
            if dumper is not None:
                dumper.add(pred_np, pairs[n][0])
        n += 1
        if verbose and n % 100 == 0:
            print(f"  [{spec.name}] {n}/{len(pairs)} images, {n / (time.time() - t0):.2f} im/s")
    if dumper is not None:
        dumper.write()
    return _finish(acc, spec, n, t0, verbose)
