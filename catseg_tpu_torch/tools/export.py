"""Export CLI: write the serving pipeline as a ``torch.export`` artifact
(catseg_tpu/tools/export.py).

    python -m catseg_tpu_torch.tools.export --config vitb384 --checkpoint model.pth \\
        --classes "sky,building,road" --canvas 1024x1024 --out-canvas 768x768 \\
        --output catseg_b16.pt2 [--device cpu] [--check]

The whole serving graph, canvas -> in-graph resizes -> sliding-window
forward through the kernel ops -> fold / average -> resize-argmax, with the
weights and text features as its state.  In place of the reference's
``--platforms`` it takes ``--device``: a ``.pt2`` is bound to the device it
was traced on, and it loads only where ``catseg_tpu_torch`` is importable
(``infer.export.load_exported``).  ``--check`` reloads the artifact and
holds it bit-equal to the live pipeline on one random image.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..core.catseg import compute_dtype
from ..data.catalogs import load_class_names
from ..infer.export import ExportSpec, export_serving, load_exported, make_serve_fn
from ..text.embed import forward_text_embeds
from .common import add_device_arg, load_params, resolve_config


def _hw(s: str) -> tuple[int, int]:
    h, _, w = s.partition("x")
    return int(h), int(w)


def main(argv=None) -> dict:
    """Returns {"path", "export_s", "mb", and with --check "load_s", "check"}."""
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--config", default="vitb384")
    ap.add_argument("--checkpoint", default=None)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--classes", default=None, help="comma-separated class names")
    src.add_argument("--class-json", default=None)
    ap.add_argument("--canvas", default="1024x1024", help="static input canvas HxW")
    ap.add_argument("--out-canvas", default="768x768", help="static argmax canvas HxW")
    ap.add_argument("--output", default="catseg_serving.pt2")
    ap.add_argument("--check", action="store_true",
                    help="reload the artifact and compare against the live pipeline")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = resolve_config(args.config, args.overrides).replace(sliding_window=True, pooling_size=(1, 1))
    model = load_params(args.checkpoint, cfg, device=args.device)
    names = args.classes.split(",") if args.classes else load_class_names(args.class_json)
    with torch.inference_mode():
        text_feats = forward_text_embeds(model.clip, [n.strip() for n in names], cfg.prompt_ensemble_type,
                                         compute_dtype=compute_dtype(cfg))
    text_feats = text_feats.clone()

    spec = ExportSpec(input_canvas=_hw(args.canvas), out_canvas=_hw(args.out_canvas), num_classes=len(names))
    t = time.perf_counter()
    export_serving(model, cfg, text_feats, spec, args.output)
    out = {"path": args.output, "export_s": time.perf_counter() - t, "mb": os.path.getsize(args.output) / 1e6}
    print(f"exported {args.output} ({out['mb']:.1f} MB in {out['export_s']:.1f} s, device {args.device}, "
          f"T={len(names)}, canvas {spec.input_canvas} -> {spec.out_canvas})")

    if args.check:
        rng = np.random.RandomState(0)
        Hc, Wc = spec.input_canvas
        h, w = int(Hc * 0.7), int(Wc * 0.9)
        canvas = np.zeros((Hc, Wc, 3), np.uint8)
        canvas[:h, :w] = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
        hw = np.asarray([h, w], np.int32)
        out_hw = np.asarray([int(h * 0.8), int(w * 0.8)], np.int32)
        t = time.perf_counter()
        artifact = load_exported(args.output)
        out["load_s"] = time.perf_counter() - t
        got = artifact(canvas, hw, out_hw).cpu().numpy()
        dev = next(model.parameters()).device
        with torch.inference_mode():
            want = make_serve_fn(model, cfg, text_feats, spec)(
                *(torch.as_tensor(a, device=dev) for a in (canvas, hw, out_hw))).cpu().numpy()
        out["check"] = bool(np.array_equal(got, want))
        if not out["check"]:
            raise SystemExit(f"artifact mismatch: {np.mean(got != want):.2%} of pixels differ")
        print(f"check OK: artifact == live pipeline (loaded in {out['load_s']:.1f} s)")
    return out


if __name__ == "__main__":
    main()
