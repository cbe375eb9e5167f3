"""The port's CLIP image and text encoders against catseg_tpu's, on the CPU.

A mini ViT (patch 16 at 384^2, width 128, 2 heads of 64, 3 layers) keeps
the JAX side on its kernel paths: dense attention at head_dim 64, the
Pallas LayerNorm (>= 512 rows of 128), the 14 -> 24 bicubic pos-embed
resize, guidance taps (0, 1) and the dense final block.  Weights go JAX
init -> export_clip_state_dict -> load_state_dict(strict=True).  fp32;
tolerance 1e-4 abs (summation order only).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catseg_tpu import configs as jconfigs
from catseg_tpu.core import clip as jclip
from catseg_tpu.text.embed import forward_text_embeds as j_text_embeds
from catseg_tpu.text.tokenizer import tokenize
from catseg_tpu.weights.export import export_clip_state_dict

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core import clip as tclip
from catseg_tpu_torch.text.embed import forward_text_embeds as t_text_embeds

MINI = jconfigs.CLIPVariant("mini-B/16", 16, 128, 3, 2, 64, 224, 128, 2, 2)
MINI_PORT = tconfigs.CLIPVariant("mini-B/16", 16, 128, 3, 2, 64, 224, 128, 2, 2)
NAMES = ["wall", "building, edifice", "sky", "floor, flooring", "tree", "ceiling"]


@pytest.fixture(scope="module")
def models():
    params = jclip.init_clip_params(jax.random.PRNGKey(0), MINI)
    model = tclip.CLIP(MINI_PORT)
    sd = {k: torch.tensor(v) for k, v in export_clip_state_dict(params).items()}
    model.load_state_dict(sd, strict=True)
    return params, model


def test_encode_image_matches_jax(models):
    params, model = models
    imgs = np.random.RandomState(0).randn(2, 384, 384, 3).astype(np.float32)
    jt, jtaps = jclip.encode_image(params, jnp.asarray(imgs), MINI, dense=True, taps=(0, 1))
    with torch.no_grad():
        tt, ttaps = tclip.encode_image(model, torch.from_numpy(imgs), taps=(0, 1))
    assert tt.shape == (2, 577, 64) and len(ttaps) == 2
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4, rtol=0)
    for a, b in zip(ttaps, jtaps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


def test_truncate_context_and_encode_text_match_jax(models):
    params, model = models
    ids = tokenize(["a photo of a wall in the scene", "sky", "an airplane flying over the big city"])
    cut = tclip.truncate_context(ids)
    np.testing.assert_array_equal(cut, jclip.truncate_context(ids))
    assert cut.shape[1] % 8 == 0 and cut.shape[1] < 77
    want = jclip.encode_text(params, jnp.asarray(cut), MINI)
    with torch.no_grad():
        got = tclip.encode_text(model, torch.as_tensor(cut))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_forward_text_embeds_match_jax(models):
    params, model = models
    want = j_text_embeds(params, NAMES, "single", MINI)
    got = t_text_embeds(model, NAMES, "single")
    assert got.shape == (6, 1, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
