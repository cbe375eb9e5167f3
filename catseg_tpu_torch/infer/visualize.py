"""Semantic-segmentation visuals (catseg_tpu/infer/visualize.py): colour
overlays and the [image | prediction | ground truth] strip.

The reference's arithmetic on numpy arrays.  Its two calls into its imaging
library are the port's own: ``overlay`` resizes the image with
``data.resize.resize_bicubic_u8`` (the library's default ``Image.resize``
filter is bicubic), and ``save_visual`` writes with
``data.image_write.save_image`` (the format by suffix; a ``.jpg`` at
libjpeg's defaults decodes to the pixels the reference's file does).
"""

from __future__ import annotations

import colorsys

import numpy as np

from ..data.image_write import save_image
from ..data.resize import resize_bicubic_u8


def build_palette(num_classes: int, seed: int = 1) -> np.ndarray:
    """(K, 3) uint8 distinct colours (golden-ratio hue walk)."""
    rng = np.random.RandomState(seed)
    colors = []
    h = rng.rand()
    for _ in range(num_classes):
        h = (h + 0.61803398875) % 1.0
        s = 0.55 + 0.4 * rng.rand()
        v = 0.75 + 0.25 * rng.rand()
        colors.append([int(255 * c) for c in colorsys.hsv_to_rgb(h, s, v)])
    return np.asarray(colors, dtype=np.uint8)


def colorize(seg: np.ndarray, palette: np.ndarray, ignore_label: int | None = None) -> np.ndarray:
    """(H, W) int ids -> (H, W, 3) uint8; ignore pixels are black."""
    out = np.zeros(seg.shape + (3,), dtype=np.uint8)
    valid = np.ones(seg.shape, bool)
    if ignore_label is not None:
        valid = seg != ignore_label
    ids = np.clip(seg, 0, len(palette) - 1)
    out[valid] = palette[ids[valid]]
    return out


def overlay(image: np.ndarray, seg: np.ndarray, palette: np.ndarray, alpha: float = 0.5,
            ignore_label: int | None = None) -> np.ndarray:
    """Blend a colourized segmentation over the RGB image (bicubic-resized to
    the segmentation's size where they differ)."""
    color = colorize(seg, palette, ignore_label).astype(np.float32)
    img = image.astype(np.float32)
    if img.shape[:2] != seg.shape:
        img = resize_bicubic_u8(image.astype(np.uint8), seg.shape).astype(np.float32)
    return np.clip((1 - alpha) * img + alpha * color, 0, 255).astype(np.uint8)


def visual_panel(image: np.ndarray, pred: np.ndarray, gt: np.ndarray | None, num_classes: int,
                 ignore_label: int = 255, alpha: float = 0.5) -> np.ndarray:
    """The [image | pred overlay | gt overlay] strip :func:`save_visual` writes."""
    palette = build_palette(num_classes)
    panels = [image.astype(np.uint8), overlay(image, pred, palette, alpha)]
    if gt is not None:
        panels.append(overlay(image, gt, palette, alpha, ignore_label=ignore_label))
    H = min(p.shape[0] for p in panels)
    return np.concatenate([p[:H] for p in panels], axis=1)


def save_visual(image: np.ndarray, pred: np.ndarray, gt: np.ndarray | None, out_path: str,
                num_classes: int, ignore_label: int = 255, alpha: float = 0.5) -> None:
    """Side-by-side [image | pred overlay | gt overlay] (viz.py:332-365 analog)."""
    save_image(out_path, visual_panel(image, pred, gt, num_classes, ignore_label, alpha))
