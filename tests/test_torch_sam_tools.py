"""The port's standalone SAM tools against catseg_tpu's, on the CPU, fp32.

The mini SAM of tests/test_torch_sam.py (patch 16 at its own 64^2 input:
grid 4, low-res masks 16^2; the prompt encoder and two-layer mask decoder
of the mini Ver14 model, dim 32), weights from test_torch_fusion.params
("ver14", seed=1) in both packages.  catseg_tpu's SamPredictor resizes
with PIL, the port's with its host library's Pillow-exact resize.

- ``resize_longest_side``, ``build_point_grid``, ``stability_score`` and
  ``_nms`` equal catseg_tpu's;
- ``SamPredictor`` on a non-square 45x70 image (the canvas's pad rows and
  the crop run): the image embedding, and for point, box, point + box and
  mask prompts with multimask on and off the upscaled mask logits, the
  IoU predictions and the low-res logits, within 5e-4 (max |d|; measured
  at most 1.8e-4 and a mean of at most 3.4e-5 on logits up to 20 in
  magnitude: the image embeddings agree to 4.3e-6 and this mini decoder's
  doubled weights scale that up);
- ``AutomaticMaskGenerator.generate`` with 3 points a side and every
  threshold at -1e9 (tests/test_amg.py): the same records in the same
  order, boxes and points equal, stability within 1e-5, IoU within 1e-4
  of max(1, |IoU|), and the RLEs equal for every mask with no logit within
  1e-4 of the cutoff (none has one here).  The IoU bound is what this
  random decoder allows: the two encoders' embeddings agree to ~1e-6 of
  their size, and a 1e-6 relative perturbation of the port's own embedding
  moves its IoUs by 6.0e-5 and its logits by 2.5e-4 (catseg_tpu's IoUs
  differ from the port's by up to 4.1e-5 at 1.39).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catseg_tpu.core import sam as jsam
from catseg_tpu.infer import amg as jamg
from catseg_tpu.infer import sam_predictor as jpred

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core import sam as tsam
from catseg_tpu_torch.core.catseg import model_class
from catseg_tpu_torch.infer import amg
from catseg_tpu_torch.infer.sam_predictor import SamPredictor, resize_longest_side
from catseg_tpu_torch.weights.from_jax import load_params_

from test_torch_fusion import close, fusion_cfg, params

VARIANT = "torch_mini_sam"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as tests/test_torch_fusion.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sam():
    """(catseg_tpu pytree, the port's Ver14 model) of the mini SAM."""
    tree = params("ver14", seed=1)
    cfg = fusion_cfg(tconfigs, "ver14")
    return tree, load_params_(model_class(cfg)(cfg), tree).eval()


@pytest.fixture(scope="module")
def predictors(sam):
    """Both packages' predictors after set_image of the same 45x70 image."""
    tree, model = sam
    image = np.random.RandomState(3).randint(0, 256, (45, 70, 3)).astype(np.uint8)
    jp = jpred.SamPredictor(tree["sam"], tree["sam_pe"], tree["sam_dec"], jsam.SAM_VARIANTS[VARIANT])
    tp = SamPredictor(model, device="cpu")
    jp.set_image(image)
    tp.set_image(image)
    return jp, tp


def _helper_case(name):
    rng = np.random.RandomState(0)
    if name == "resize_longest_side":
        sizes = [(45, 70, 64), (480, 640, 1024), (640, 480, 1024), (333, 500, 1024), (1024, 1024, 1024),
                 (1, 999, 1024), (2000, 1500, 64)]
        return [resize_longest_side(*s) for s in sizes], [jpred.resize_longest_side(*s) for s in sizes]
    if name == "build_point_grid":
        return ([amg.build_point_grid(n) for n in (1, 3, 4, 32)], [jamg.build_point_grid(n) for n in (1, 3, 4, 32)])
    if name == "stability_score":
        logits = (rng.randn(6, 3, 16, 16) * 2).astype(np.float32)
        logits[0] = 5.0
        logits[1] = -5.0
        return (amg.stability_score(torch.from_numpy(logits)).numpy(),
                np.asarray(jamg.stability_score(jnp.asarray(logits))))
    xy = rng.uniform(0, 50, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 30, (40, 2))], axis=1).astype(np.float32)
    scores = rng.rand(40).astype(np.float32)
    return ([amg._nms(boxes, scores, t) for t in (0.1, 0.5, 0.9)],
            [jamg._nms(boxes, scores, t) for t in (0.1, 0.5, 0.9)])


@pytest.mark.parametrize("name", ["resize_longest_side", "build_point_grid", "stability_score", "nms"])
def test_helpers_match_jax(name):
    got, want = _helper_case(name)
    if isinstance(got, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    else:
        np.testing.assert_array_equal(got, want)


def test_set_image_matches_jax(predictors):
    """The resized, normalized, padded canvas through the SAM encoder."""
    jp, tp = predictors
    assert tp.input_size == jp.input_size == (41, 64) and tp.original_size == (45, 70)
    emb = tp.get_image_embedding()
    assert emb.shape == (1, 4, 4, 32) and emb.dtype == torch.float32
    assert np.abs(np.asarray(jp.get_image_embedding())).max() > 0.5
    close(emb.numpy(), jp.get_image_embedding())


PROMPTS = ["point", "box", "point_box", "mask"]


def _prompt(kind):
    rng = np.random.RandomState(PROMPTS.index(kind))
    kw = {}
    if kind in ("point", "point_box"):
        kw.update(point_coords=np.array([[20.0, 30.0], [50.0, 10.0]], np.float32), point_labels=np.array([1, 0]))
    if kind in ("box", "point_box"):
        kw.update(box=np.array([8.0, 5.0, 60.0, 40.0], np.float32))
    if kind == "mask":
        kw.update(mask_input=(rng.randn(16, 16) * 3).astype(np.float32))
    return kw


@pytest.mark.parametrize("multimask", [False, True], ids=["single", "multimask"])
@pytest.mark.parametrize("kind", PROMPTS)
def test_predict_matches_jax(predictors, kind, multimask):
    """Mask logits at the original size, IoU predictions and low-res logits."""
    jp, tp = predictors
    kw = _prompt(kind)
    got = tp.predict(multimask_output=multimask, return_logits=True, **kw)
    want = jp.predict(multimask_output=multimask, return_logits=True, **kw)
    n = 3 if multimask else 1
    assert got[0].shape == (n, 45, 70) and got[1].shape == (n,) and got[2].shape == (n, 16, 16)
    assert np.abs(want[2]).max() > 1.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(g - w).max() < 5e-4, np.abs(g - w).max()
    masks = tp.predict(multimask_output=multimask, **kw)[0]
    assert masks.dtype == bool
    np.testing.assert_array_equal(masks, got[0] > 0.0)


def test_amg_matches_jax(sam):
    tree, model = sam
    variant = jsam.SAM_VARIANTS[VARIANT]
    kw = dict(points_per_side=3, pred_iou_thresh=-1e9, stability_score_thresh=-1e9, box_nms_thresh=0.9)
    # seed 1: four records survive NMS at 0.9 (seed 0's masks all cover the
    # whole 16^2 grid, and NMS keeps one)
    img = np.random.RandomState(1).randn(64, 64, 3).astype(np.float32)
    want = jamg.AutomaticMaskGenerator(tree["sam"], tree["sam_pe"], tree["sam_dec"], variant, **kw).generate(img)
    gen = amg.AutomaticMaskGenerator(model, device="cpu", **kw)
    got = gen.generate(img)
    assert len(got) == len(want) == 4
    with torch.inference_mode():
        feat = gen.encoder(torch.from_numpy(img)[None])
        pts = amg.build_point_grid(3) * np.float32(64)
        logits, iou, _ = amg._decode_point_grid(gen.pe, gen.dec, feat, torch.from_numpy(pts), (64, 64))
    logits, iou = logits.flatten(0, 1).numpy(), iou.flatten().numpy()
    near_cutoff = 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["bbox"] == w["bbox"] and g["point_coords"] == w["point_coords"]
        assert abs(g["predicted_iou"] - w["predicted_iou"]) <= 1e-4 * max(1.0, abs(w["predicted_iou"]))
        assert abs(g["stability_score"] - w["stability_score"]) <= 1e-5
        i = int(np.flatnonzero(iou == np.float32(g["predicted_iou"]))[0])
        if np.abs(logits[i]).min() <= 1e-4:
            near_cutoff += 1
            continue
        assert g["segmentation"] == w["segmentation"]
    # with these weights no mask has a logit within 1e-4 of the cutoff
    assert near_cutoff == 0
