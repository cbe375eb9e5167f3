"""The port's top-k class truncation (T > pad_len) against catseg_tpu's, on the CPU.

The mini flagship config of test_torch_aggregator.py (fp32, the fused
decoder asked for, as the default configuration does) at pad_len 8 with
T = 10 classes: only the 8 best-scoring classes are aggregated and the other
2 get exactly -100.  ``torch.topk`` may order tied classes differently from
``jax.lax.top_k`` and every later stage is equivariant under a permutation
of the kept classes, so the kept *sets* are compared, and each kept class's
logits by class index (1e-4 abs, summation order).  Probabilities of the
sliding-window Predictor: max 5e-4, mean 2e-5 (the README's oracle bound).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catseg_tpu.core.aggregator import aggregator_forward as j_aggregator_forward
from catseg_tpu.infer.pipeline import Predictor as JPredictor
from catseg_tpu.weights.export import export_aggregator_state_dict

from catseg_tpu_torch.core.aggregator import Aggregator, aggregator_forward, gather_classes, topk_classes
from catseg_tpu_torch.core.catseg import CATSeg
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


NAMES = ["wall", "building, edifice", "sky", "floor, flooring", "tree", "ceiling", "road, route",
         "bed", "windowpane, window", "grass"]
T = len(NAMES)


@pytest.fixture(scope="module")
def params():
    return mini_params(seed=2)


@pytest.fixture(scope="module")
def agg_case(params):
    agg = Aggregator(mini_cfg_port(fused_decoder=True))
    agg.load_state_dict({k: torch.tensor(v) for k, v in export_aggregator_state_dict(params["agg"]).items()},
                        strict=True)
    rng = np.random.RandomState(4)
    img = rng.randn(2, 24, 24, 64).astype(np.float32)
    txt = rng.randn(2, T, 1, 64).astype(np.float32)
    guid = tuple(rng.randn(2, s, s, c).astype(np.float32) for s, c in ((24, 64), (48, 256), (96, 128)))
    jcfg, tcfg = mini_cfg(fused_decoder=True), mini_cfg_port(fused_decoder=True)
    want, want_cls = j_aggregator_forward(params["agg"], jnp.asarray(img), jnp.asarray(txt),
                                          tuple(jnp.asarray(g) for g in guid), jcfg, return_classes=True)
    args = (torch.from_numpy(img), torch.from_numpy(txt), tuple(torch.from_numpy(g) for g in guid), tcfg)
    with torch.no_grad():
        got, got_cls = aggregator_forward(agg, *args, return_classes=True)
        full = aggregator_forward(agg, *args)
    return (np.asarray(want), np.asarray(want_cls)), (got.numpy(), got_cls.numpy()), full.numpy()


def test_topk_keeps_the_same_classes(agg_case):
    (_, want_cls), (got, got_cls), _ = agg_case
    assert got.shape == (2, 8, 96, 96) and got_cls.shape == (2, 8)
    for b in range(2):
        assert set(got_cls[b].tolist()) == set(want_cls[b].tolist())


def test_topk_kept_logits_match_jax(agg_case):
    (want, want_cls), (got, got_cls), _ = agg_case
    for b in range(2):
        w = {int(c): want[b, i] for i, c in enumerate(want_cls[b])}
        for i, c in enumerate(got_cls[b]):
            np.testing.assert_allclose(got[b, i], w[int(c)], atol=1e-4, rtol=0)


def test_topk_scatter_drops_to_minus_100(agg_case):
    (want, want_cls), (got, got_cls), full = agg_case
    assert full.shape == (2, T, 96, 96)
    for b in range(2):
        dropped = sorted(set(range(T)) - set(got_cls[b].tolist()))
        assert len(dropped) == 2 and (full[b, dropped] == -100.0).all()
        np.testing.assert_array_equal(full[b, got_cls[b]], got[b])


def test_topk_helpers():
    corr = torch.zeros(1, 5, 2, 2, 1)
    corr[0, [3, 1, 4], 0, 0, 0] = torch.tensor([0.9, 0.5, 0.7])
    idx = topk_classes(corr, 3)
    assert idx.tolist() == [[3, 4, 1]]
    x = torch.arange(5.0)[None, :, None]
    assert gather_classes(x, idx)[0, :, 0].tolist() == [3.0, 4.0, 1.0]


def test_topk_predictor_matches_jax(params):
    rng = np.random.RandomState(5)
    images = [rng.randint(0, 256, (120, 160, 3), dtype=np.uint8),
              rng.randint(0, 256, (96, 128, 3), dtype=np.uint8)]
    jp = JPredictor(params, mini_cfg(fused_decoder=True), NAMES, input_canvas=(128, 160))
    cfg = mini_cfg_port(fused_decoder=True)
    tp = Predictor(load_params_(CATSeg(cfg), params), cfg, NAMES, device="cpu")
    want = np.asarray(jp.probs_sliding_batch(images))
    got = tp.probs_sliding_batch(images).numpy()
    assert got.shape == want.shape == (2, 640, 640, T)
    d = np.abs(got - want)
    assert d.max() < 5e-4 and d.mean() < 2e-5, (d.max(), d.mean())
