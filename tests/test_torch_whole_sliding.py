"""The port's single-image serving API on the sliding-window branch against
catseg_tpu's, on the CPU: the sliding-window half of tests/test_torch_whole.py
(its config, parameters, images and tolerances), in a file of its own so
that the two halves run on two workers.  Also the AsyncPredictor's order.
"""

import threading
import time

import numpy as np
import pytest
import torch

from catseg_tpu_torch.infer.async_predictor import AsyncPredictor

from test_torch_aggregator import mini_params
from test_torch_whole import _close, _predictors, check_probs_predict_and_argmax


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads: the sliding window's 5 tiles and 6 classes at
    640^2 are large enough to split, unlike the whole-image branch's ops
    (one thread in tests/test_torch_whole.py); beside the suite's parallel
    workers and JAX's threads, four took twice as long as two."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sliding():
    return _predictors(mini_params(seed=1), "sliding")


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(1)
    return [rng.randint(0, 256, (120, 160, 3), dtype=np.uint8),
            rng.randint(0, 256, (96, 128, 3), dtype=np.uint8)]


@pytest.mark.parametrize("branch", ["sliding"])
def test_probs_predict_and_argmax_match_jax(sliding, images, branch):
    """The sliding-window branch (the whole-image one: test_torch_whole.py)."""
    check_probs_predict_and_argmax(*sliding, images, branch)


def test_probs_sliding_is_the_batch_row(sliding, images):
    """probs_sliding matches catseg_tpu's and is row 0 of the batch path."""
    jp, tp = sliding
    got = tp.probs_sliding(images[0])
    assert got.shape == (640, 640, 6)
    _close(got.numpy(), jp.probs_sliding(images[0]))
    assert torch.equal(got, tp.probs_sliding_batch(images[:1])[0])


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
