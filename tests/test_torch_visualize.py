"""The port's visuals against catseg_tpu's and the reference imaging
library, on the CPU: the palette, colourize / overlay / the saved strip,
Pillow-exact BICUBIC on uint8, the JPEG and PNG writers, and
``tools.viz_results`` on tests/test_viz_results.py's setup.

Tolerances: every array bit-equal.  A port JPEG is held to the reference
library's JPEG of the same array once both are decoded by that library,
pixel for pixel (and byte for byte: same tables, same coefficients).
"""

import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from catseg_tpu.evaluation.coco_dump import PredictionDumper
from catseg_tpu.infer import visualize as jvis
from catseg_tpu.tools.viz_results import render_predictions_json as j_render

from catseg_tpu_torch.data import image_io, resize
from catseg_tpu_torch.data.image_write import encode_jpeg, encode_png, save_image
from catseg_tpu_torch.infer import visualize as tvis
from catseg_tpu_torch.tools.viz_results import render_predictions_json as t_render


def _decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _pil_jpeg(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("k", [20, 150, 847])
def test_palette_matches(k):
    assert np.array_equal(tvis.build_palette(k), jvis.build_palette(k))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (45, 61, 3), dtype=np.uint8)
    pred = rng.randint(0, 20, (45, 61)).astype(np.int32)
    gt = rng.randint(0, 20, (45, 61)).astype(np.int32)
    gt[:7] = 255
    return image, pred, gt


def test_colorize_and_overlay_match(scene):
    image, pred, gt = scene
    pal = jvis.build_palette(20)
    assert np.array_equal(tvis.colorize(gt, pal, 255), jvis.colorize(gt, pal, 255))
    assert np.array_equal(tvis.colorize(gt, pal), jvis.colorize(gt, pal))
    for alpha in (0.5, 0.3):
        assert np.array_equal(tvis.overlay(image, pred, pal, alpha), jvis.overlay(image, pred, pal, alpha))
    # a segmentation of another size: the image is resized (the library's default, bicubic)
    small = pred[::2, ::3]
    assert np.array_equal(tvis.overlay(image, small, pal), jvis.overlay(image, small, pal))
    big = np.repeat(pred, 2, axis=0)
    assert np.array_equal(tvis.overlay(image, big, pal, 0.4, 255), jvis.overlay(image, big, pal, 0.4, 255))


@pytest.mark.parametrize("with_gt", [True, False])
def test_save_visual_strip_matches(scene, tmp_path, with_gt):
    image, pred, gt = scene
    g = gt if with_gt else None
    jvis.save_visual(image, pred, g, str(tmp_path / "ref.jpg"), 20)
    tvis.save_visual(image, pred, g, str(tmp_path / "port.jpg"), 20)
    pal = jvis.build_palette(20)
    panels = [image, jvis.overlay(image, pred, pal)] + ([jvis.overlay(image, gt, pal, ignore_label=255)] if with_gt
                                                        else [])
    strip = np.concatenate(panels, axis=1)
    assert np.array_equal(tvis.visual_panel(image, pred, g, 20), strip)
    ref, port = (tmp_path / "ref.jpg").read_bytes(), (tmp_path / "port.jpg").read_bytes()
    assert np.array_equal(_decode(port), _decode(ref))
    assert port == ref


SIZES = [((37, 53), (60, 80)), ((37, 53), (13, 7)), ((480, 640), (384, 512)), ((17, 9), (17, 31)),
         ((5, 3), (40, 3)), ((100, 101), (1, 1)), ((64, 48), (64, 48))]


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("src,dst", SIZES)
def test_bicubic_matches_reference_library(src, dst, channels):
    rng = np.random.RandomState(src[0] * 7 + dst[1] + channels)
    img = rng.randint(0, 256, src + ((channels,) if channels else ()), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BICUBIC))
    assert np.array_equal(resize.resize_bicubic_u8(img, dst), want)
    assert np.array_equal(resize.resize_bicubic_u8_numpy(img, dst), want)
    # the library's default filter is bicubic (the visuals' resizes name none)
    assert np.array_equal(np.asarray(Image.fromarray(img).resize(dst[::-1])), want)


@pytest.mark.parametrize("shape", [(8, 8, 3), (17, 33, 3), (1, 1, 3), (99, 301, 3), (15, 7, 3), (64, 1, 3),
                                   (37, 53), (8, 9), (120, 3)])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_jpeg_decodes_as_the_reference_library_file(shape, kind):
    rng = np.random.RandomState(sum(shape))
    if kind == "noise":
        arr = rng.randint(0, 256, shape, dtype=np.uint8)
    else:
        y, x = np.mgrid[0:shape[0], 0:shape[1]]
        planes = [(x * 3 + y) % 256, (y * 5) % 256, ((x + y) * 2) % 256]
        arr = (np.stack(planes, -1) if len(shape) == 3 else planes[0]).astype(np.uint8)
    mine, ref = encode_jpeg(arr), _pil_jpeg(arr)
    assert np.array_equal(_decode(mine), _decode(ref))
    assert mine == ref
    # the port's own decoder reads it too
    assert np.array_equal(image_io._jpeg(mine, "x.jpg")[0], _decode(ref))


@pytest.mark.parametrize("shape", [(31, 17), (5, 40, 3), (1, 1)])
def test_png_is_lossless(shape, tmp_path):
    arr = np.random.RandomState(shape[0]).randint(0, 256, shape, dtype=np.uint8)
    save_image(tmp_path / "a.png", arr)
    assert np.array_equal(np.asarray(Image.open(tmp_path / "a.png")), arr)
    assert np.array_equal(image_io.decode_array(str(tmp_path / "a.png")), arr)
    assert encode_png(arr) == (tmp_path / "a.png").read_bytes()


def test_save_image_by_suffix(tmp_path):
    arr = np.random.RandomState(5).randint(0, 256, (20, 30, 3), dtype=np.uint8)
    for name in ("a.jpg", "b.JPEG"):
        save_image(tmp_path / name, arr)
        assert np.array_equal(_decode((tmp_path / name).read_bytes()), _decode(_pil_jpeg(arr)))
    for name in ("c.bmp", "d"):
        with pytest.raises(NotImplementedError, match="bmp" if "." in name else "without a suffix"):
            save_image(tmp_path / name, arr)
    with pytest.raises(ValueError):
        save_image(tmp_path / "e.png", arr.astype(np.float32))


def _viz_dataset(root: str):
    """tests/test_viz_results.py's dataset and dump."""
    img_dir = os.path.join(root, "VOCdevkit/VOC2012/JPEGImages")
    gt_dir = os.path.join(root, "VOCdevkit/VOC2012/annotations_detectron2/val")
    os.makedirs(img_dir)
    os.makedirs(gt_dir)
    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate([(40, 60), (50, 30)]):
        p = os.path.join(img_dir, f"im{i}.jpg")
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(p)
        Image.fromarray(rng.randint(0, 20, (h, w)).astype(np.uint8)).save(os.path.join(gt_dir, f"im{i}.png"))
        paths.append(p)
    dump = os.path.join(root, "preds.json")
    d = PredictionDumper(dump)
    for p, (h, w) in zip(paths, [(40, 60), (50, 30)]):
        pred = rng.randint(0, 20, (h, w)).astype(np.int32)
        pred[:3] = 255   # unpredicted rows
        d.add(pred, p)
    d.write()
    return dump


def test_viz_results_matches_reference(tmp_path):
    dump = _viz_dataset(str(tmp_path))
    n_ref = j_render(dump, str(tmp_path / "ref"), "voc20", root=str(tmp_path))
    n_port = t_render(dump, str(tmp_path / "port"), "voc20", root=str(tmp_path))
    assert n_ref == n_port == 2
    files = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == files == ["im0.jpg", "im1.jpg"]
    for f in files:
        ref, port = (tmp_path / "ref" / f).read_bytes(), (tmp_path / "port" / f).read_bytes()
        assert np.array_equal(_decode(port), _decode(ref))
    assert _decode((tmp_path / "port" / "im0.jpg").read_bytes()).shape == (40, 180, 3)
    assert t_render(dump, str(tmp_path / "one"), "voc20", root=str(tmp_path), limit=1) == 1
    assert json.loads(open(dump).read())
