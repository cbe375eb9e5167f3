"""The port's confusion matrix and metrics (evaluation/miou.py) against
catseg_tpu's, on the CPU.  Integer counts and the numpy metrics must be
exactly equal: the void column for the ignore label, the VOC-b background
clamp and the generalized zero-shot split included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catseg_tpu.evaluation import miou as jm

from catseg_tpu_torch.evaluation import miou as tm

K = 21


def _pairs(seed, shape=(3, 37, 53), ignore=255):
    rng = np.random.RandomState(seed)
    pred = rng.randint(0, K, shape).astype(np.int32)
    gt = rng.randint(0, K, shape).astype(np.int32)
    gt[rng.rand(*shape) < 0.15] = ignore
    return pred, gt


@pytest.mark.parametrize("clamp", [False, True], ids=["plain", "voc_b"])
def test_confusion_update_matches_jax(clamp):
    pred, gt = _pairs(0)
    k = K if not clamp else 30     # clamp folds classes above 20 into background 20
    if clamp:
        pred = np.random.RandomState(1).randint(0, k, pred.shape).astype(np.int32)
    want = jm.confusion_update(jnp.zeros((k + 1, k + 1), jnp.int32), jnp.asarray(pred), jnp.asarray(gt),
                               jnp.asarray(gt == 255), num_classes=k, clamp_background=clamp)
    got = tm.confusion_update(torch.zeros((k + 1, k + 1), dtype=torch.int64), torch.from_numpy(pred),
                              torch.from_numpy(gt), torch.from_numpy(gt == 255), k, clamp)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_accumulator_and_metrics_match_jax():
    ja = jm.ConfusionAccumulator(K, ignore_label=255)
    ta = tm.ConfusionAccumulator(K, ignore_label=255, device="cpu")
    for seed in range(3):
        pred, gt = _pairs(seed + 10)
        ja.update(pred, gt)
        ta.update(pred, gt)
    np.testing.assert_array_equal(ta.matrix(), ja.matrix())
    assert ta.cm.device.type == "cpu"
    want, got = ja.metrics(), ta.metrics()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_ignore_label_goes_to_void_column():
    ta = tm.ConfusionAccumulator(3, ignore_label=7, device="cpu")
    ta.update(np.array([[0, 1, 2, 2]]), np.array([[0, 7, 2, 1]]))
    cm = ta.matrix()
    assert cm[1, 3] == 1 and cm[:, 3].sum() == 1 and cm.sum() == 4


def test_gzero_metrics_match_jax():
    pred, gt = _pairs(20)
    cm = np.asarray(jm.confusion_update(jnp.zeros((K + 1, K + 1), jnp.int32), jnp.asarray(pred),
                                        jnp.asarray(gt), jnp.asarray(gt == 255), num_classes=K))
    seen, unseen = list(range(15)), list(range(15, K))
    want, got = jm.gzero_metrics(cm, seen, unseen), tm.gzero_metrics(cm, seen, unseen)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


def test_accumulator_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tm.ConfusionAccumulator(3, 255).cm.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tm.ConfusionAccumulator(3, 255)
