"""The port's single-image serving API against catseg_tpu's, on the CPU.

Both Predictors run the mini config of test_torch_aggregator.py (fp32, T = 6
< pad_len 8) from the same parameters, on two uint8 images whose sides are
not multiples of crop_size (384), in both branches: the whole image
(``sliding_window=False`` at the model's default pooling (2, 2)) and the
sliding window (the eval preset).  Tolerances as test_torch_pipeline.py:
probabilities max 5e-4 and mean 2e-5 (the README's oracle bound); argmax
maps agree on >= 99.9% of pixels (an fp32 near-tie between classes may
flip).  The compositions mirror tests/test_eval_infer.py's, at its own 2e-5
abs and 1e-4 rel.
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from catseg_tpu.infer.pipeline import Predictor as JPredictor
from catseg_tpu.infer.pipeline import whole_image_probs as j_whole_image_probs

from catseg_tpu_torch.configs import CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, FusionConfig, eval_preset
from catseg_tpu_torch.core.aggregator import aggregator_forward
from catseg_tpu_torch.core.catseg import CATSeg
from catseg_tpu_torch.infer.async_predictor import AsyncPredictor
from catseg_tpu_torch.infer.pipeline import (Predictor, resize_argmax, whole_image_probs,
                                             whole_image_probs_padded)
from catseg_tpu_torch.weights.from_jax import load_params_

from test_torch_aggregator import mini_cfg, mini_cfg_port, mini_params

NAMES = ["wall", "building, edifice", "sky", "floor, flooring", "tree", "ceiling"]
BRANCHES = {"whole": dict(sliding_window=False, pooling_size=(2, 2)), "sliding": {}}


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() < 5e-4 and d.mean() < 2e-5, (d.max(), d.mean())


@pytest.fixture(scope="module")
def params():
    return mini_params(seed=1)


def _predictors(params, branch):
    kw = BRANCHES[branch]
    jp = JPredictor(params, mini_cfg().replace(**kw), NAMES)
    cfg = mini_cfg_port().replace(**kw)
    return jp, Predictor(load_params_(CATSeg(cfg), params), cfg, NAMES, device="cpu")


@pytest.fixture(scope="module")
def whole(params):
    return _predictors(params, "whole")


@pytest.fixture(scope="module")
def sliding(params):
    return _predictors(params, "sliding")


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(1)
    return [rng.randint(0, 256, (120, 160, 3), dtype=np.uint8),
            rng.randint(0, 256, (96, 128, 3), dtype=np.uint8)]


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_probs_predict_and_argmax_match_jax(request, images, branch):
    """probs (probs_whole, probs_sliding), predict and predict_argmax follow
    cfg.sliding_window and agree with catseg_tpu's in each branch."""
    jp, tp = request.getfixturevalue(branch)
    side = 640 if branch == "sliding" else 96
    for im in images:
        got = tp.probs(im)
        assert got.shape == (side, side, 6) and got.dtype == torch.float32
        _close(got.numpy(), jp.probs(im))
        mine = tp.probs_sliding(im) if branch == "sliding" else tp.probs_whole(im)
        assert torch.equal(got, mine)
        sem = tp.predict(im)["sem_seg"]
        assert sem.shape == (6, *im.shape[:2]) and sem.dtype == np.float32
        _close(sem, jp.predict(im)["sem_seg"])
        pred = tp.predict_argmax(im)
        assert pred.shape == im.shape[:2] and pred.dtype == np.int32
        assert (pred == jp.predict_argmax(im)).mean() >= 0.999
    pred = tp.predict_argmax(images[0], out_hw=(60, 90))
    assert pred.shape == (60, 90) and (pred == jp.predict_argmax(images[0], out_hw=(60, 90))).mean() >= 0.999


def test_probs_sliding_is_the_batch_row(sliding, images):
    """probs_sliding matches catseg_tpu's and is row 0 of the batch path."""
    jp, tp = sliding
    got = tp.probs_sliding(images[0])
    assert got.shape == (640, 640, 6)
    _close(got.numpy(), jp.probs_sliding(images[0]))
    assert torch.equal(got, tp.probs_sliding_batch(images[:1])[0])


def test_whole_image_probs_matches_jax(params, images):
    """The unpadded whole_image_probs (one model forward) against catseg_tpu's."""
    jcfg, cfg = mini_cfg(), mini_cfg_port()
    model = load_params_(CATSeg(cfg), params).eval()
    text = np.random.RandomState(3).randn(5, 1, 64).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    im = images[0].astype(np.float32)
    want = j_whole_image_probs(params, jnp.asarray(im), jnp.asarray(text), jcfg)
    with torch.inference_mode():
        got = whole_image_probs(model, torch.from_numpy(im), torch.from_numpy(text), cfg)
    assert got.shape == (96, 96, 5)
    _close(got.numpy(), want)


def test_whole_image_probs_matches_reference_composition(params):
    """The whole-image branch == normalize -> zero-pad to crop_size multiples
    -> resize to clip_resolution -> forward -> sigmoid (cat_seg_model.py:
    147-155), as tests/test_eval_infer.py holds catseg_tpu's."""
    cfg = mini_cfg_port(crop_size=64).replace(sliding_window=False)   # SIZE_DIVISIBILITY 64
    model = load_params_(CATSeg(cfg), params).eval()
    rng = np.random.RandomState(7)
    h, w = 100, 150
    img = rng.randint(0, 255, (h, w, 3)).astype(np.float32)
    text = torch.from_numpy(rng.randn(5, 1, 64).astype(np.float32))
    with torch.inference_mode():
        got = whole_image_probs_padded(model, torch.from_numpy(img), text, cfg)
        assert got.shape == (96, 96, 5)
        norm = np.zeros((128, 192, 3), np.float32)
        norm[:h, :w] = (img - np.asarray(CLIP_PIXEL_MEAN, np.float32)) / np.asarray(CLIP_PIXEL_STD, np.float32)
        t_in = F.interpolate(torch.from_numpy(norm).permute(2, 0, 1)[None], size=(cfg.clip_resolution,) * 2,
                             mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
        feats, guid = model.guidance_features(t_in)
        want = torch.sigmoid(aggregator_forward(model.agg, feats, text[None], guid, cfg)[0]).permute(1, 2, 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-4)
    with pytest.raises(NotImplementedError, match="A8"):
        whole_image_probs_padded(model, torch.from_numpy(img), text, cfg.replace(fusion=FusionConfig()))


def test_predict_routes_whole_image_branch(params):
    """predict_argmax follows cfg.sliding_window like the reference
    meta-arch, as tests/test_eval_infer.py holds catseg_tpu's."""
    cfg = mini_cfg_port().replace(sliding_window=False)
    model = load_params_(CATSeg(cfg), params)
    rng = np.random.RandomState(0)
    text = rng.randn(7, 1, 64).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    pred = Predictor(model, cfg, [f"c{i}" for i in range(7)], text_feats=text, device="cpu")
    img = rng.randint(0, 255, (100, 120, 3)).astype(np.uint8)
    whole = pred.probs_whole(img)
    assert whole.shape != pred.probs_sliding(img).shape
    want = resize_argmax(whole.permute(2, 0, 1), img.shape[:2]).numpy()
    np.testing.assert_array_equal(pred.predict_argmax(img), want)


def test_predictor_refuses_a_config_of_another_architecture(params):
    """A Predictor's cfg may differ from its model's in run-time fields
    (eval_preset, the dtype) but not in one the model is built from."""
    cfg = mini_cfg_port().replace(sliding_window=False)
    model = load_params_(CATSeg(cfg), params)
    text = np.ones((2, 1, 64), np.float32) / 8
    Predictor(model, eval_preset(cfg).replace(compute_dtype="bfloat16"), ["a", "b"], text_feats=text, device="cpu")
    for kw in (dict(pad_len=cfg.pad_len + 1), dict(num_heads=1), dict(hidden_dim=256)):
        with pytest.raises(ValueError, match=next(iter(kw))):
            Predictor(model, cfg.replace(**kw), ["a", "b"], text_feats=text, device="cpu")


def test_recorded_calls_reach_the_whole_branch_kernels(whole, images):
    """selfcheck.recorded_calls sees every forward-kernel wrapper call of a
    whole-image probs (chip_smoke.py [15] holds each against its plain
    version on the card), leaves the result alone and unpatches on exit; on
    the CPU each wrapper is its plain version, so check_calls reads 0."""
    from catseg_tpu_torch.core import aggregator as tagg
    from catseg_tpu_torch.kernels import selfcheck

    pred = whole[1]
    want = pred.probs_whole(images[0])
    with selfcheck.recorded_calls() as calls:
        got = pred.probs_whole(images[0])
    assert torch.equal(got, want)
    assert tagg.fused_swin_pair is selfcheck.FORWARD_PAIRS["swin_block"][0]
    names = [n for n, _ in calls]
    assert {"layer_norm", "dense_attention", "corr_embed", "swin_block", "class_layer"} <= set(names), names
    assert names.count("swin_block") == pred.cfg.num_layers
    errs = selfcheck.check_calls(calls, torch.float32)
    assert all(n >= 1 and err == 0.0 for n, err, _ in errs.values()), errs


def test_async_predictor_keeps_submission_order(sliding, images):
    """Results come back in submission order, as device tensors equal to
    probs_sliding's; the worker stops at shutdown."""
    _, tp = sliding

    class Slow:
        def probs_sliding(self, image):
            time.sleep(0.01 * float(image[0, 0, 0]))
            return torch.full((2,), float(image[0, 0, 0]))

    ap = AsyncPredictor(Slow(), depth=2)
    order = [3, 0, 2, 1, 4]
    feeder = threading.Thread(target=lambda: [ap.put(np.full((4, 4, 3), k, np.uint8)) for k in order])
    feeder.start()
    got = [ap.get() for _ in order]
    feeder.join(timeout=10)
    assert [i for i, _ in got] == list(range(5)) and [int(p[0]) for _, p in got] == order
    assert len(ap) == 0
    ap.shutdown()
    assert not ap._thread.is_alive()

    ap = AsyncPredictor(tp)
    assert ap.put(images[1]) == 0 and len(ap) == 1
    idx, probs = ap.get()
    assert idx == 0 and probs.device == tp.device
    assert torch.equal(probs, tp.probs_sliding(images[1]))
    ap.shutdown()


def test_async_predictor_forwards_worker_exception():
    """A worker exception surfaces in get() instead of hanging the consumer,
    and the worker goes on with the next image."""

    class Boom:
        def probs_sliding(self, image):
            if image.sum() == 0:
                raise ValueError("corrupt input")
            return torch.ones(1)

    ap = AsyncPredictor(Boom(), depth=2)
    ap.put(np.zeros((8, 8, 3), np.uint8))
    ap.put(np.ones((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="corrupt"):
        ap.get()
    assert ap.get()[0] == 1
    ap.shutdown()
    with pytest.raises(queue.Empty):
        ap._results.get_nowait()
