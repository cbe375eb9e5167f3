"""Demo CLI, the demo/demo.py equivalent (catseg_tpu/tools/demo.py).

    python -m catseg_tpu_torch.tools.demo --config vitb384 --checkpoint model.pth \\
        --input img1.jpg img2.jpg --output out/ \\
        (--class-json ade150.json | --classes "cat,dog,sky") [--device cpu]

Open-vocabulary segmentation of any images against any class list: the
sliding-window Predictor (``--tta``: D2's scales x flip), a colour overlay
written under the input's basename (``.jpg`` / ``.png`` by its suffix), the
five most frequent classes printed.  ``--parallel`` pipelines host prep with
the card (``AsyncPredictor``); ``--shard-tiles`` splits each image's tiles
over every visible GPU, one model replica a GPU (``parallel.latency``), and
with one device runs unsharded and says so.  ``--video-input f.mp4`` / ``--webcam N``
(demo/demo.py:31-47,129-194) segment every frame through OpenCV, which they
import and which neither the CPU test box nor the card's machine has: without
it they exit naming the missing package.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.catalogs import load_class_names
from ..data.image_write import save_image
from ..data.loader import load_image, resize_shortest_edge
from ..infer.pipeline import Predictor, resize_argmax
from ..infer.tta import TTAPredictor
from ..infer.visualize import build_palette, overlay
from ..parallel.mesh import make_mesh
from .common import add_device_arg, load_params, resolve_config


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise SystemExit("--video-input / --webcam read frames through OpenCV: the cv2 package is not installed "
                         f"({e})") from e
    return cv2


def main(argv=None) -> dict:
    """Returns {"preds": {input path: (H, W) argmax map}, "ms_per_image": the
    images' wall time from the first load to the last overlay written,
    model build excluded} for image inputs."""
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--config", default="vitb384")
    ap.add_argument("--checkpoint", default=None)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--input", nargs="+")
    src.add_argument("--video-input", default=None, help="video file to segment frame by frame (needs cv2)")
    src.add_argument("--webcam", nargs="?", const=0, type=int, default=None,
                     help="camera index to stream from (needs cv2)")
    ap.add_argument("--output", default="demo_out")
    ap.add_argument("--frame-stride", type=int, default=1,
                    help="segment every Nth video frame (intermediate frames reuse the last mask)")
    ap.add_argument("--classes", default=None, help="comma-separated class names")
    ap.add_argument("--class-json", default=None)
    ap.add_argument("--tta", action="store_true")
    ap.add_argument("--parallel", action="store_true",
                    help="pipeline host prep with device execution (AsyncPredictor)")
    ap.add_argument("--shard-tiles", action="store_true",
                    help="split each image's sliding-window tiles over every visible GPU (per-image latency)")
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    if args.classes:
        class_names = [c.strip() for c in args.classes.split(",")]
    elif args.class_json:
        class_names = load_class_names(args.class_json)
    else:
        raise SystemExit("pass --classes or --class-json")
    video = args.video_input is not None or args.webcam is not None
    cv2 = _cv2() if video else None
    mesh = None
    if args.shard_tiles:
        if args.device == "cuda" and torch.cuda.device_count() > 1:
            mesh = make_mesh()
        else:
            print("--shard-tiles: only one device visible, running unsharded")

    cfg = resolve_config(args.config, args.overrides).replace(sliding_window=True, pooling_size=(1, 1))
    model = load_params(args.checkpoint, cfg, device=args.device)
    predictor = Predictor(model, cfg, class_names, device=args.device, mesh=mesh)
    if args.tta:
        predictor = TTAPredictor(predictor)
    palette = build_palette(len(class_names))

    if video:
        _run_video(cv2, args, predictor, cfg, palette)
        return {}

    os.makedirs(args.output, exist_ok=True)
    preds = {}
    t0 = time.perf_counter()

    def done():
        ms = (time.perf_counter() - t0) * 1e3 / len(args.input)
        print(f"{len(args.input)} images, {ms:.1f} ms an image")
        return {"preds": preds, "ms_per_image": ms}

    def emit(path, img, pred):
        save_image(os.path.join(args.output, os.path.basename(path)), overlay(img, pred, palette, alpha=args.alpha))
        top = np.bincount(pred.reshape(-1), minlength=len(class_names)).argsort()[::-1][:5]
        print(f"{path} -> {os.path.join(args.output, os.path.basename(path))}; "
              f"top classes: {[class_names[i] for i in top]}")
        preds[path] = pred

    if args.parallel and len(args.input) > 1:
        # demo/predictor.py:132-219 (--parallel): a worker thread prepares and
        # enqueues each image while the card runs the one before
        from ..infer.async_predictor import AsyncPredictor

        ap_exec = AsyncPredictor(predictor)
        meta = []
        for path in args.input:
            img = load_image(path)
            ap_exec.put(resize_shortest_edge(img, cfg.min_size_test, cfg.max_size_test))
            meta.append((path, img))
        results = {}
        for _ in meta:
            idx, probs = ap_exec.get()
            results[idx] = probs
        ap_exec.shutdown()
        for idx, (path, img) in enumerate(meta):
            with torch.inference_mode():
                pred = resize_argmax(results[idx].permute(2, 0, 1), img.shape[:2]).cpu().numpy()
            emit(path, img, pred)
        return done()

    for path in args.input:
        img = load_image(path)
        resized = resize_shortest_edge(img, cfg.min_size_test, cfg.max_size_test)
        pred = predictor.predict(resized, out_hw=img.shape[:2])["sem_seg"].argmax(axis=0)
        emit(path, img, pred)
    return done()


def _run_video(cv2, args, predictor, cfg, palette):
    """Frame loop for --video-input / --webcam (demo/demo.py:129-194)."""
    source = args.video_input if args.video_input is not None else args.webcam
    cap = cv2.VideoCapture(source)
    if not cap.isOpened():
        raise SystemExit(f"cannot open video source {source}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    writer = None
    if args.output and args.video_input is not None:
        out_path = args.output
        if os.path.isdir(out_path) or not os.path.splitext(out_path)[1]:
            os.makedirs(out_path, exist_ok=True)
            out_path = os.path.join(out_path, os.path.basename(args.video_input))
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    n = 0
    pred = None
    try:
        while True:
            ok, frame_bgr = cap.read()
            if not ok:
                break
            img = np.ascontiguousarray(frame_bgr[:, :, ::-1])   # the model takes RGB
            if pred is None or n % args.frame_stride == 0:
                resized = resize_shortest_edge(img, cfg.min_size_test, cfg.max_size_test)
                pred = predictor.predict(resized, out_hw=img.shape[:2])["sem_seg"].argmax(axis=0)
            vis = overlay(img, pred, palette, alpha=args.alpha)
            if writer is not None:
                writer.write(vis[:, :, ::-1])
            else:
                cv2.imshow("catseg_tpu_torch demo", vis[:, :, ::-1])
                if cv2.waitKey(1) == 27:  # ESC
                    break
            n += 1
    finally:
        cap.release()
        if writer is not None:
            writer.release()
            print(f"{n} frames -> {out_path}")


if __name__ == "__main__":
    main()
