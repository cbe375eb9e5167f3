"""The port's evaluation harness, TTA and prediction dump against
catseg_tpu's, on the CPU.

Config: the mini flagship eval preset of test_torch_aggregator.py (fp32,
T = 6 < pad_len 8), the same parameters on both sides (the port's seeded
init as a JAX pytree, loaded into the port through ``from_jax``).  Dataset:
three synthetic JPEG / PNG pairs of different sizes with an ignore band.

- ``evaluate_benchmark``: catseg_tpu's on one device (``jax.devices``
  patched as tests/test_eval_cli.py does) and the port's count the same
  images, and their argmax maps agree on >= 99.9% of the counted pixels
  (the port's standard, tests/test_torch_pipeline.py); the port's batch 1
  and batch 2 give equal metrics and confusion matrices, exactly (3
  images: batch 2's tail batch runs at its own size).
- ``TTAPredictor``: probabilities at two small scales with flip within 5e-4
  of catseg_tpu's (the README's oracle bound).
- The COCO dump: records equal to catseg_tpu's.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from catseg_tpu.data import catalogs as jcatalogs
from catseg_tpu.evaluation import coco_dump as jdump
from catseg_tpu.evaluation import harness as jharness
from catseg_tpu.infer.pipeline import Predictor as JPredictor
from catseg_tpu.infer.tta import TTAPredictor as JTTAPredictor

from catseg_tpu_torch.core.catseg import CATSeg
from catseg_tpu_torch.data import catalogs as tcatalogs
from catseg_tpu_torch.evaluation import coco_dump as tdump
from catseg_tpu_torch.evaluation import harness as tharness
from catseg_tpu_torch.infer.pipeline import Predictor
from catseg_tpu_torch.infer.tta import TTAPredictor
from catseg_tpu_torch.weights.from_jax import load_params_

from test_torch_aggregator import mini_cfg, mini_cfg_port, mini_params

NAMES = ["wall", "building, edifice", "sky", "floor, flooring", "tree", "ceiling"]



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the mini model's many small ops would each wait on
    a barrier of the whole pool, which stalls when the suite's parallel
    workers oversubscribe the cores (as tests/test_torch_train.py does)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture(scope="module")
def params():
    return mini_params(seed=1)


@pytest.fixture(scope="module")
def model(params):
    return load_params_(CATSeg(mini_cfg_port()), params).eval()


@pytest.fixture
def dataset(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    (tmp_path / "imgs").mkdir()
    (tmp_path / "gts").mkdir()
    for i, (h, w) in enumerate([(100, 130), (121, 97), (90, 140)]):
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(tmp_path / "imgs" / f"im{i}.jpg")
        gt = rng.randint(0, len(NAMES), (h, w)).astype(np.uint8)
        gt[:10] = 255
        Image.fromarray(gt).save(tmp_path / "gts" / f"im{i}.png")
    (tmp_path / "mini_classes.json").write_text(json.dumps(NAMES))
    for cat in (jcatalogs, tcatalogs):
        spec = cat.DatasetSpec("mini_synth", "imgs", "gts", "mini_classes.json", len(NAMES), 255)
        monkeypatch.setitem(cat.DATASETS, "mini_synth", spec)
        monkeypatch.setattr(cat, "_class_json_search", lambda: (str(tmp_path),))
    return tmp_path


def _recording(module, monkeypatch):
    """Swap the harness module's ConfusionAccumulator for one that keeps
    every (pred, gt) it is fed."""
    seen = []

    class Recording(module.ConfusionAccumulator):
        def update(self, pred, gt):
            seen.append(tuple(np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a) for a in (pred, gt)))
            super().update(pred, gt)

    monkeypatch.setattr(module, "ConfusionAccumulator", Recording)
    return seen


def _counted(seen, ignore=255):
    """Per-image predictions and GT on the counted pixels; pad rows (all
    ignore) drop out."""
    preds, gts = [], []
    for pred, gt in seen:
        pred, gt = pred.reshape(-1, *pred.shape[-2:]), gt.reshape(-1, *gt.shape[-2:])
        for p, g in zip(pred, gt):
            if (g != ignore).any():
                preds.append(p[g != ignore])
                gts.append(g[g != ignore])
    return np.concatenate(preds), np.concatenate(gts)


def test_harness_matches_jax_and_batch_1_equals_batch_2(dataset, params, model, monkeypatch):
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a: one)
    jseen = _recording(jharness, monkeypatch)
    tseen = _recording(tharness, monkeypatch)
    want = jharness.evaluate_benchmark(params, mini_cfg(), "mini_synth", root=str(dataset), eval_batch=2)
    runs = {b: tharness.evaluate_benchmark(model, mini_cfg_port(), "mini_synth", root=str(dataset), eval_batch=b)
            for b in (2, 1)}
    got = runs[2]
    assert got["num_images"] == want["num_images"] == 3
    jp, jg = _counted(jseen)
    tp, tg = _counted(tseen[:2])   # batch 2's updates: [im0, im1], then the tail batch [im2] at its own size
    assert np.array_equal(jg, tg) and len(tg) > 0
    assert (jp == tp).mean() >= 0.999
    assert all(np.isfinite(got[k]) for k in ("mIoU", "fwIoU", "mACC", "pACC"))
    # the port's batch 1 and batch 2 give equal matrices and metrics, exactly
    assert np.array_equal(runs[1]["_conf"], runs[2]["_conf"])
    for k in ("mIoU", "fwIoU", "mACC", "pACC", "num_images"):
        assert runs[1][k] == runs[2][k], k
    assert runs[1]["_conf"].sum() == 3 * 256 * 256   # every image counted on the 256-step out canvas


def test_harness_refuses_unported_options(dataset, model):
    with pytest.raises(NotImplementedError, match="A7"):
        tharness.evaluate_benchmark(model, mini_cfg_port(), "mini_synth", root=str(dataset), dump_visuals=1)


def test_tta_probs_match_jax(params, model):
    image = np.random.RandomState(2).randint(0, 256, (90, 120, 3), dtype=np.uint8)
    jt = JTTAPredictor(JPredictor(params, mini_cfg(), NAMES), min_sizes=(96, 128), max_size=4000)
    tt = TTAPredictor(Predictor(model, mini_cfg_port(), NAMES, device="cpu"), min_sizes=(96, 128), max_size=4000)
    want = np.asarray(jt.probs_sliding(image))
    got = tt.probs(image).numpy()
    assert got.shape == want.shape == (640, 640, len(NAMES))
    assert np.abs(got - want).max() < 5e-4


def test_tta_pair_is_one_batch_call(model, monkeypatch):
    """The {image, flip} pair goes through one probs_sliding_batch call, and
    the flipped half is flipped back."""
    pred = Predictor(model, mini_cfg_port(), NAMES, device="cpu")
    calls = []
    real = pred.probs_sliding_batch
    monkeypatch.setattr(pred, "probs_sliding_batch", lambda images: (calls.append((images, real(images))))
                        or calls[-1][1])
    image = np.random.RandomState(3).randint(0, 256, (64, 80, 3), dtype=np.uint8)
    p = TTAPredictor(pred, min_sizes=None).probs(image)
    assert len(calls) == 1
    (images, out), = calls
    assert len(images) == 2 and np.array_equal(images[0], image) and np.array_equal(images[1], image[:, ::-1])
    assert torch.equal(p, (out[0] + out[1].flip(1)) / 2)


def test_coco_dump_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    pred = rng.randint(0, 171, (37, 53)).astype(np.int32)
    pred[:5] = 7
    spec = tcatalogs.get_dataset("coco_2017_test_stuff_all_sem_seg")
    id_map = tdump.dataset_id_map(spec)
    assert id_map == jdump.dataset_id_map(jcatalogs.get_dataset("coco_2017_test_stuff_all_sem_seg"))
    assert tdump.dataset_id_map(tcatalogs.get_dataset("ade150")) is None
    for m in (None, id_map):
        assert tdump.predictions_to_coco(pred, "a.jpg", m) == jdump.predictions_to_coco(pred, "a.jpg", m)
    for mask in ((pred == 7), np.ones((4, 6), bool), np.zeros((3, 2), bool)):
        rle = tdump.rle_encode(mask)
        assert np.array_equal(tdump.rle_decode(rle), mask.astype(np.uint8))
    dumper = tdump.PredictionDumper(str(tmp_path / "p.json"), id_map)
    dumper.add(pred, "a.jpg")
    dumper.write()
    assert json.loads((tmp_path / "p.json").read_text()) == jdump.predictions_to_coco(pred, "a.jpg", id_map)


def test_dump_predictions_through_the_harness(dataset, model, tmp_path):
    out = tmp_path / "sem_seg_predictions.json"
    m = tharness.evaluate_benchmark(model, mini_cfg_port(), "mini_synth", root=str(dataset), limit=1,
                                    dump_predictions=str(out), verbose=False)
    recs = json.loads(out.read_text())
    assert m["num_images"] == 1 and {r["file_name"].rsplit("/", 1)[-1] for r in recs} == {"im0.jpg"}
    for r in recs:
        assert 0 <= r["category_id"] < len(NAMES) and sum(r["segmentation"]["counts"]) == np.prod(
            r["segmentation"]["size"])
