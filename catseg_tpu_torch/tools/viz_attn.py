"""Attention-map visualization CLI, the viz_atten.py equivalent
(catseg_tpu/tools/viz_attn.py).

    python -m catseg_tpu_torch.tools.viz_attn --config vitb384 --checkpoint m.pth \\
        --input img.jpg --layers 3,7,11 --output attn_out/ [--device cpu]

Writes, for each requested visual block, a grey PNG of each head's CLS ->
patch attention heatmap side by side, ``{base}_layer{l}_heads.png``.  The
maps are fp32 (``core.clip.encode_image_attn_maps``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core.catseg import normalize_clip
from ..core.clip import encode_image_attn_maps
from ..data.image_write import save_image
from ..data.loader import load_image
from ..ops import resize_bilinear
from .common import add_device_arg, load_params, resolve_config


def head_grid(attn: np.ndarray, grid: int) -> np.ndarray:
    """(heads, 1+G^2, 1+G^2) -> uint8 image: a row of CLS-attention heatmaps."""
    heads = attn.shape[0]
    panels = []
    for h in range(heads):
        cls_attn = attn[h, 0, 1:].reshape(grid, grid)
        m = cls_attn / max(cls_attn.max(), 1e-8)
        panels.append((255 * m).astype(np.uint8))
    row = np.concatenate(panels, axis=1)
    return np.repeat(np.repeat(row, 8, axis=0), 8, axis=1)


@torch.inference_mode()
def attention_maps(model, cfg, image: np.ndarray, layers: tuple[int, ...]) -> list[torch.Tensor]:
    """(H, W, 3) uint8 -> the requested layers' (1, heads, 1+G^2, 1+G^2) fp32
    maps of the image CLIP-normalized and resized to clip_resolution."""
    device = next(model.parameters()).device
    R = cfg.clip_resolution
    x = normalize_clip(torch.as_tensor(np.ascontiguousarray(image), device=device).float()[None])
    return encode_image_attn_maps(model.clip, resize_bilinear(x, (R, R)), attn_layers=layers)


def main(argv=None) -> list[str]:
    """Returns the paths written."""
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--config", default="vitb384")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--input", required=True)
    ap.add_argument("--layers", default="3,7")
    ap.add_argument("--output", default="attn_out")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = resolve_config(args.config, args.overrides)
    layers = tuple(int(x) for x in args.layers.split(","))
    bad = [l for l in layers if not 0 <= l < cfg.clip.layers]  # noqa: E741
    if bad:
        raise SystemExit(f"--layers {bad} out of range for {cfg.clip.name} (0..{cfg.clip.layers - 1})")
    model = load_params(args.checkpoint, cfg, device=args.device)
    maps = attention_maps(model, cfg, load_image(args.input), layers)

    os.makedirs(args.output, exist_ok=True)
    grid = cfg.clip_resolution // cfg.clip.patch
    base = os.path.splitext(os.path.basename(args.input))[0]
    written = []
    for layer, attn in zip(sorted(set(layers)), maps):
        out = os.path.join(args.output, f"{base}_layer{layer}_heads.png")
        save_image(out, head_grid(attn[0].cpu().numpy(), grid))
        print(f"layer {layer}: {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
