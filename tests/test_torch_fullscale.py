"""The port against catseg_tpu at full width, on the CPU.

``vitb384(compute_dtype="float32")``: CLIP ViT-B/16 at 384^2 (12 layers,
width 768, 577 tokens), the 2-layer aggregator at hidden 128, T = 150
(the ADE-20k names shipped with the port, byte-identical to catseg_tpu's),
one template.  Both packages hold the same parameters: catseg_tpu's
``init_catseg_params(PRNGKey(0))`` loaded into the port by ``load_params_``.
The text encoders are compared at tests/test_fullscale_parity.py's text
bound (3e-4 abs, 1e-3 rel); then catseg_tpu's text features feed both image
paths on one seeded 427x640 image: the whole-image branch (the model's
default, pooling 2x2) and the sliding window under ``eval_preset``, at that
file's bound (max |d prob| < 5e-4, mean < 2e-5).  The sliding window's
case is in tests/test_torch_fullscale_sliding.py, so that the two files run
on two workers.
"""

import numpy as np
import pytest
import torch

import jax

from catseg_tpu import configs as jconfigs
from catseg_tpu.core.catseg import init_catseg_params
from catseg_tpu.infer.pipeline import Predictor as JPredictor
from catseg_tpu.text.embed import forward_text_embeds as j_text_embeds

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core.catseg import CATSeg
from catseg_tpu_torch.infer.pipeline import Predictor
from catseg_tpu_torch.text.embed import forward_text_embeds as t_text_embeds
from catseg_tpu_torch.weights.from_jax import load_params_

T = 150


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads: beside the suite's parallel workers and JAX's
    threads, the default pool (one thread a core) took ~1.7x as long."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def make_models():
    jcfg = jconfigs.vitb384(compute_dtype="float32")
    params = jax.tree.map(np.asarray, jax.jit(lambda k: init_catseg_params(k, jcfg))(jax.random.PRNGKey(0)))
    model = load_params_(CATSeg(tconfigs.vitb384(compute_dtype="float32")), params).eval()
    return params, model


def make_names():
    names = tconfigs.class_names("ade150")
    assert len(names) == T
    return names


def make_text(models, names):
    params, _ = models
    return j_text_embeds(params["clip"], names, "single", jconfigs.vitb384().clip)


def make_image():
    return np.random.RandomState(3).randint(0, 255, (427, 640, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def names():
    return make_names()


@pytest.fixture(scope="module")
def text(models, names):
    return make_text(models, names)


@pytest.fixture(scope="module")
def image():
    return make_image()


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() < 5e-4 and d.mean() < 2e-5, (d.max(), d.mean())


def test_text_fullscale(models, names, text):
    _, model = models
    got = t_text_embeds(model.clip, names, "single")
    assert got.shape == text.shape == (T, 1, 512)
    np.testing.assert_allclose(got.numpy(), text, atol=3e-4, rtol=1e-3)


def check_image_path(models, names, text, image, branch):
    params, model = models
    jcfg, tcfg = jconfigs.vitb384(compute_dtype="float32"), tconfigs.vitb384(compute_dtype="float32")
    if branch == "sliding":
        jcfg, tcfg = jconfigs.eval_preset(jcfg), tconfigs.eval_preset(tcfg)
    jp = JPredictor(params, jcfg, names, text_feats=text)
    tp = Predictor(model, tcfg, names, text_feats=text, device="cpu")
    if branch == "whole":
        got, want = tp.probs_whole(image), jp.probs_whole(image)
        assert got.shape == (96, 96, T)
    else:
        got, want = tp.probs_sliding(image), jp.probs_sliding(image)
        assert got.shape == (640, 640, T)
    _close(got.numpy(), want)


@pytest.mark.parametrize("branch", ["whole"])
def test_image_paths_fullscale(models, names, text, image, branch):
    """The whole-image branch (the sliding one: test_torch_fullscale_sliding.py)."""
    check_image_path(models, names, text, image, branch)
