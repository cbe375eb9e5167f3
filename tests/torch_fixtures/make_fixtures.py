"""Write the port's committed image fixtures with the imaging library (PIL)
and record their digests.

    python tests/torch_fixtures/make_fixtures.py

The GPU machine has no imaging library to write or decode files with, so
chip_smoke.py checks the port's decoder and resize there against
``digests.json``: the sha256 of PIL's decoded arrays (``convert("RGB")`` and
the GT view the JAX package's ``load_gt`` takes) and of the bilinear
``resize_shortest_edge(..., 640, 2560)`` of the 480x640 JPEG.
tests/test_torch_data.py re-derives every digest with PIL.

``dataset/`` is a 4-image ADE-20k-150 layout (two sizes, JPEG images, PNG
GT in [0, 150) with a 255 band) for the eval and train CLIs.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
ADE_IMAGES = "dataset/ADEChallengeData2016/images/validation"
ADE_GT = "dataset/ADEChallengeData2016/annotations_detectron2/validation"


def photo(rng, h, w):
    """Smooth colour fields, edges and mild noise: a JPEG-friendly stand-in
    for a photograph."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(x / (23 + 9 * c) + c) * np.cos(y / (31 - 5 * c)) for c in range(3)], -1)
    img[(x - w / 2) ** 2 + (y - h / 2) ** 2 < (min(h, w) / 4) ** 2] += 40
    return np.clip(img + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)


def regions(rng, h, w, n_classes, block=16):
    """Blocky label map with a 255 band along the top."""
    gh, gw = -(-h // block), -(-w // block)
    gt = np.kron(rng.randint(0, n_classes, (gh, gw)), np.ones((block, block), np.int64))[:h, :w]
    gt[: h // 10] = 255
    return gt


def sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def decoded(path: Path) -> dict:
    with Image.open(path) as im:
        raw = np.asarray(im)
        rgb = np.asarray(im.convert("RGB"))
    gt = (raw[..., 0] if raw.ndim == 3 else raw).astype(np.int32)
    return {"rgb": sha(rgb), "gt": sha(gt), "shape": list(raw.shape)}


def main():
    rng = np.random.RandomState(0)
    (HERE / "images").mkdir(exist_ok=True)
    big = photo(rng, 480, 640)
    Image.fromarray(big).save(HERE / "images/photo_420.jpg", quality=75, subsampling=2)
    small = photo(rng, 96, 131)
    Image.fromarray(small).save(HERE / "images/photo_444.jpg", quality=90, subsampling=0)
    Image.fromarray(small).save(HERE / "images/progressive.jpg", quality=85, progressive=True)
    Image.fromarray(small[..., 1]).save(HERE / "images/grey.jpg", quality=80)
    Image.fromarray(small[..., 0]).save(HERE / "images/L.png")
    pal = Image.fromarray(regions(rng, 57, 83, 150, block=8).astype(np.uint8), "P")
    pal.putpalette(list(rng.randint(0, 256, 768).astype(np.uint8)))
    pal.save(HERE / "images/P.png")
    Image.fromarray(np.dstack([small[:40, :50], rng.randint(0, 256, (40, 50, 1)).astype(np.uint8)]),
                    "RGBA").save(HERE / "images/RGBA.png")
    Image.fromarray(regions(rng, 61, 77, 847, block=8).astype(np.uint16)).save(HERE / "images/gt16.tif", "TIFF")

    for d in (ADE_IMAGES, ADE_GT):
        (HERE / d).mkdir(parents=True, exist_ok=True)
    for i, (h, w) in enumerate([(240, 320), (240, 320), (300, 200), (300, 200)]):
        Image.fromarray(photo(rng, h, w)).save(HERE / f"{ADE_IMAGES}/fixture_{i}.jpg", quality=75)
        Image.fromarray(regions(rng, h, w, 150).astype(np.uint8)).save(HERE / f"{ADE_GT}/fixture_{i}.png")

    files = sorted(p for p in HERE.rglob("*") if p.suffix in (".jpg", ".png", ".tif"))
    digests = {"files": {str(p.relative_to(HERE)): decoded(p) for p in files}}
    with Image.open(HERE / "images/photo_420.jpg") as im:
        rgb = im.convert("RGB")
    # loader.shortest_edge_size(480, 640, 640, 2560) = (640, 853)
    digests["resize"] = {"file": "images/photo_420.jpg", "short_max": [640, 2560],
                         "sha256": sha(np.asarray(rgb.resize((853, 640), Image.BILINEAR)))}
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    print(f"{len(files)} files, {sum(p.stat().st_size for p in files)} bytes")


if __name__ == "__main__":
    main()
