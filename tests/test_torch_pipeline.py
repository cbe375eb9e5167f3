"""The port's sliding-window slice against catseg_tpu's, on the CPU.

Both Predictors run the mini flagship config of test_torch_aggregator.py
(fp32, T = 6 < pad_len 8) on two uint8 images of different sizes, from the
same parameters.  Tolerances: probabilities max 5e-4 and mean 2e-5 (the
README's oracle bound); argmax maps agree on >= 99.9% of pixels (an fp32
near-tie between classes may flip).
"""

import numpy as np
import pytest

from catseg_tpu.infer.pipeline import Predictor as JPredictor

from catseg_tpu_torch.core.catseg import CATSeg
from catseg_tpu_torch.infer.pipeline import Predictor
from catseg_tpu_torch.weights.from_jax import load_params_

from test_torch_aggregator import mini_cfg, mini_params

NAMES = ["wall", "building, edifice", "sky", "floor, flooring", "tree", "ceiling"]


@pytest.fixture(scope="module")
def predictors():
    cfg = mini_cfg()
    params = mini_params(seed=1)
    jp = JPredictor(params, cfg, NAMES, input_canvas=(128, 160))
    tp = Predictor(load_params_(CATSeg(cfg), params), cfg, NAMES)
    return jp, tp


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(1)
    return [rng.randint(0, 256, (120, 160, 3), dtype=np.uint8),
            rng.randint(0, 256, (96, 128, 3), dtype=np.uint8)]


def test_sliding_probs_match_jax(predictors, images):
    jp, tp = predictors
    np.testing.assert_allclose(tp.text_feats.numpy(), np.asarray(jp.text_feats), atol=1e-5, rtol=0)
    want = np.asarray(jp.probs_sliding_batch(images))
    got = tp.probs_sliding_batch(images).numpy()
    assert got.shape == want.shape == (2, 640, 640, 6)
    d = np.abs(got - want)
    assert d.max() < 5e-4 and d.mean() < 2e-5, (d.max(), d.mean())


def test_sliding_preds_match_jax(predictors, images):
    jp, tp = predictors
    hws = np.array([im.shape[:2] for im in images], np.int32)
    want = np.asarray(jp.preds_sliding_batch(images, hws, (120, 160)))
    got = tp.preds_sliding_batch(images, hws, (120, 160)).numpy()
    assert got.shape == want.shape == (2, 120, 160) and got.dtype == np.int32
    assert (got >= 0).all() and (got < 6).all()
    assert (got == want).mean() >= 0.999
