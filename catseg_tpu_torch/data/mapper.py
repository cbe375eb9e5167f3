"""Train-time dataset mapper, host side, numpy (catseg_tpu/data/mapper.py).

Reproduces MaskFormerSemanticDatasetMapper (reference:
cat_seg/data/dataset_mappers/mask_former_semantic_dataset_mapper.py:61-186):
ResizeShortestEdge(384, sampling "choice") -> random crop 384x384 with the
single-category-area constraint -> SSD color augmentation -> random hflip ->
pad to size-divisibility with image value 128 / GT 255.  Randomness uses a
numpy Generator; exact RNG parity with detectron2 is neither possible nor
needed — the distributions match.  The draws come in the JAX module's order,
and decode and resizes give its bytes (``data.image_io``, ``data.resize``), so
one seed gives the JAX package's crops bit for bit.

Data parallelism: ``train_batches(..., rank=r, world_size=n)`` yields rank
r's contiguous slice of each global batch, equal to that slice of the
one-process batch of the same seed.  Every rank makes every draw in order,
but for another rank's sample it only replays them (:func:`skip_sample`):
the draws need the resized size, which the image's header gives, and the
crop's category-area retries (off in the released configs) need the label
map, which is then decoded.  The host cost of a skipped sample is one header
read, where decoding it would cost a JPEG decode, two resizes and the colour
augmentation.
"""

from __future__ import annotations

import numpy as np

from ..parallel.mesh import INDIVISIBLE
from .image_io import probe_size
from .loader import load_gt, load_image, resize_shortest_edge, shortest_edge_size
from .resize import resize_nearest


def _resize_gt(gt: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Nearest resize of the GT as a 32-bit map (the reference's mode "I")."""
    return resize_nearest(gt.astype(np.int32), hw)


def random_crop_category_area(
    img: np.ndarray,
    gt: np.ndarray,
    size: int,
    rng: np.random.Generator,
    ignore: int,
    max_area: float = 1.0,
    retries: int = 10,
):
    """RandomCrop_CategoryAreaConstraint: retry until no single category
    dominates more than max_area of the crop (max_area=1.0 disables, as in
    the released configs — configs/config.yaml INPUT.CROP)."""
    h, w = gt.shape
    ch, cw = min(size, h), min(size, w)
    for _ in range(retries):
        y = rng.integers(0, h - ch + 1)
        x = rng.integers(0, w - cw + 1)
        crop = gt[y : y + ch, x : x + cw]
        if max_area >= 1.0:
            break
        labels, counts = np.unique(crop, return_counts=True)
        counts = counts[labels != ignore]
        if len(counts) == 0 or counts.max() <= max_area * counts.sum():
            break
    return img[y : y + ch, x : x + cw], crop


def _color_aug_decisions(rng: np.random.Generator) -> dict:
    """Draw every ColorAugSSDTransform coin/parameter: brightness w.p. 0.5,
    contrast w.p. 0.5 (applied before or after the color ops on a fair order
    coin), saturation and hue each *independently* w.p. 0.5.  The hue delta
    is an integer in [-18, 18] on the cv2 H channel, whose unit is 2 degrees
    (H in [0, 180)), i.e. up to +-36 degrees."""
    return {
        "brightness": rng.uniform(-32, 32) if rng.integers(2) else None,
        "contrast_first": bool(rng.integers(2)),
        "contrast": rng.uniform(0.5, 1.5) if rng.integers(2) else None,
        "saturation": rng.uniform(0.5, 1.5) if rng.integers(2) else None,
        "hue": int(rng.integers(-18, 19)) if rng.integers(2) else None,
    }


def color_aug_ssd(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """SSD photometric distortion (detectron2 point_rend ColorAugSSDTransform
    semantics; see _color_aug_decisions for the distribution)."""
    d = _color_aug_decisions(rng)
    img = img.astype(np.float32)
    if d["brightness"] is not None:
        img += d["brightness"]
    if d["contrast_first"] and d["contrast"] is not None:
        img *= d["contrast"]
    # the reference does two gated HSV round trips (saturation, then hue);
    # value-wise equal to one round trip applying both
    if d["saturation"] is not None or d["hue"] is not None:
        hsv = _rgb_to_hsv(np.clip(img, 0, 255))
        if d["saturation"] is not None:
            hsv[..., 1] = np.clip(hsv[..., 1] * d["saturation"], 0.0, 1.0)
        if d["hue"] is not None:
            hsv[..., 0] = (hsv[..., 0] + d["hue"] / 180.0) % 1.0
        img = _hsv_to_rgb(hsv)
    if not d["contrast_first"] and d["contrast"] is not None:
        img *= d["contrast"]
    return np.clip(img, 0, 255)


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    r, g, b = rgb[..., 0] / 255.0, rgb[..., 1] / 255.0, rgb[..., 2] / 255.0
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    df = mx - mn
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(
            df == 0, 0.0,
            np.where(mx == r, ((g - b) / df) % 6, np.where(mx == g, (b - r) / df + 2, (r - g) / df + 4)),
        ) / 6.0
        s = np.where(mx == 0, 0.0, df / mx)
    return np.stack([h, s, mx], axis=-1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0] * 6.0, np.clip(hsv[..., 1], 0, 1), hsv[..., 2]
    i = np.floor(h).astype(np.int32) % 6
    f = h - np.floor(h)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    r = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [v, q, p, p, t, v])
    g = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [t, v, v, q, p, p])
    b = np.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5], [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1) * 255.0


def train_sample(
    image_path: str,
    gt_path: str,
    rng: np.random.Generator,
    crop_size: int = 384,
    min_size: tuple[int, ...] = (384,),
    color_aug: bool = True,
    ignore: int = 255,
    single_category_max_area: float = 1.0,
    max_size: int = 1333,
) -> tuple[np.ndarray, np.ndarray]:
    """One augmented (image (S,S,3) uint8, gt (S,S) int32/uint8) training pair.

    The image is uint8 like the reference's (detectron2's ColorAugSSDTransform
    re-quantizes to uint8 and the mapper feeds uint8 tensors; normalization
    happens inside the model, cat_seg_model.py:127), a quarter of fp32's
    host-to-device bytes.  GT rides uint8 when the labels fit."""
    img = load_image(image_path)
    gt = load_gt(gt_path)
    # detectron2 ResizeShortestEdge(MIN_SIZE_TRAIN, MAX_SIZE_TRAIN): CAT-Seg
    # leaves MAX_SIZE_TRAIN at d2's default 1333, so panoramas rescale to the
    # long-side cap (and the 384-crop then sees the capped image)
    short = int(rng.choice(min_size))
    img = resize_shortest_edge(img, short, max_size=max_size)
    gt = _resize_gt(gt, img.shape[:2])
    img, gt = random_crop_category_area(img, gt, crop_size, rng, ignore, single_category_max_area)
    if color_aug:
        img = color_aug_ssd(img.astype(np.float32), rng)
    img = np.clip(img, 0, 255).astype(np.uint8)
    if rng.integers(2):
        img = img[:, ::-1]
        gt = gt[:, ::-1]
    if 0 <= ignore <= 255 and (gt >= 0).all() and (gt <= 255).all():
        gt = gt.astype(np.uint8)
    # pad to crop_size (value 128 image / 255 gt, mapper lines 141-151)
    H, W = gt.shape
    if H < crop_size or W < crop_size:
        pi = np.full((crop_size, crop_size, 3), 128, np.uint8)
        pg = np.full((crop_size, crop_size), ignore, gt.dtype)
        pi[:H, :W] = img
        pg[:H, :W] = gt
        img, gt = pi, pg
    return np.ascontiguousarray(img), np.ascontiguousarray(gt)


def skip_sample(
    image_path: str,
    gt_path: str,
    rng: np.random.Generator,
    crop_size: int = 384,
    min_size: tuple[int, ...] = (384,),
    color_aug: bool = True,
    ignore: int = 255,
    single_category_max_area: float = 1.0,
    max_size: int = 1333,
) -> None:
    """Make exactly the draws :func:`train_sample` makes for this pair,
    without decoding the image: its resized size comes from the header."""
    short = int(rng.choice(min_size))
    hw = shortest_edge_size(*probe_size(image_path), short, max_size)
    if single_category_max_area < 1.0:
        gt = _resize_gt(load_gt(gt_path), hw)      # the retries read the crop's labels
    else:
        gt = np.broadcast_to(np.uint8(0), hw)      # only the shape is read
    random_crop_category_area(gt, gt, crop_size, rng, ignore, single_category_max_area)
    if color_aug:
        _color_aug_decisions(rng)
    rng.integers(2)


def train_batches(pairs, batch_size: int, rng: np.random.Generator, rank: int = 0, world_size: int = 1, **kw):
    """Infinite generator of (images (b,S,S,3), gts (b,S,S)) batches: rank
    ``rank``'s contiguous slice, b = batch_size / world_size, of each global
    batch of ``batch_size`` (the whole batch at world_size 1).  A batch that
    does not divide over the ranks raises, as catseg_tpu's jitted step does.
    On a class axis pass the mesh's data index and data size: the class
    ranks of a data row take the same images."""
    if batch_size % world_size:
        raise NotImplementedError(f"a batch of {batch_size} does not divide over {world_size} ranks: {INDIVISIBLE}")
    local = batch_size // world_size
    mine = range(rank * local, (rank + 1) * local)
    idx = np.arange(len(pairs))
    while True:
        rng.shuffle(idx)
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            samples = []
            for k, j in enumerate(idx[i : i + batch_size]):
                if k in mine:
                    samples.append(train_sample(*pairs[j], rng=rng, **kw))
                else:
                    skip_sample(*pairs[j], rng=rng, **kw)
            imgs = np.stack([s[0] for s in samples])
            gts = np.stack([s[1] for s in samples])
            yield imgs, gts
