"""The port's sliding-window slice against catseg_tpu's, on the CPU.

Both Predictors run the mini flagship config of test_torch_aggregator.py
(fp32, T = 6 < pad_len 8) on two uint8 images of different sizes, from the
same parameters.  Tolerances: probabilities max 5e-4 and mean 2e-5 (the
README's oracle bound); argmax maps agree on >= 99.9% of pixels (an fp32
near-tie between classes may flip).
"""

import numpy as np
import pytest
import torch

from catseg_tpu.infer.pipeline import Predictor as JPredictor

from catseg_tpu_torch.core.catseg import CATSeg, build_catseg, init_catseg_
from catseg_tpu_torch.infer.pipeline import Predictor
from catseg_tpu_torch.weights.from_jax import load_params_

from test_torch_aggregator import mini_cfg, mini_cfg_port, mini_params


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads: beside the suite's parallel workers and JAX's
    threads, the default pool (one thread a core) took about twice as long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


NAMES = ["wall", "building, edifice", "sky", "floor, flooring", "tree", "ceiling"]


@pytest.fixture(scope="module")
def predictors():
    params = mini_params(seed=1)
    jp = JPredictor(params, mini_cfg(), NAMES, input_canvas=(128, 160))
    cfg = mini_cfg_port()
    tp = Predictor(load_params_(CATSeg(cfg), params), cfg, NAMES, device="cpu")
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


def test_entry_points_default_to_the_card():
    """The default device is the card; without one the entry points raise
    instead of running on the CPU."""
    cfg = mini_cfg_port()
    if torch.cuda.is_available():
        assert next(build_catseg(cfg, seed=0).parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_catseg(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(CATSeg(cfg), cfg, NAMES)


def test_build_catseg_seed_and_params(predictors):
    """build_catseg gives the seeded init or the loaded JAX pytree, in eval mode."""
    _, tp = predictors
    cfg = mini_cfg_port()
    seeded = build_catseg(cfg, seed=3, device="cpu")
    want = init_catseg_(CATSeg(cfg), 3).state_dict()
    assert not seeded.training and all(torch.equal(v, want[k]) for k, v in seeded.state_dict().items())
    loaded = build_catseg(cfg, params=mini_params(seed=1), device="cpu")
    assert all(torch.equal(v, tp.model.state_dict()[k]) for k, v in loaded.state_dict().items())
    with pytest.raises(ValueError, match="exactly one"):
        build_catseg(cfg, device="cpu")
