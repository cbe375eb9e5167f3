"""The port's CLIP image and text encoders against catseg_tpu's, on the CPU.

A mini ViT (patch 16 at 384^2, width 128, 2 heads of 64, 3 layers) keeps
the JAX side on its kernel paths: dense attention at head_dim 64, the
Pallas LayerNorm (>= 512 rows of 128), the 14 -> 24 bicubic pos-embed
resize, guidance taps (0, 1) and the dense final block.  Weights go JAX
init -> export_clip_state_dict -> load_state_dict(strict=True).  fp32;
tolerance 1e-4 abs (summation order only).  The non-dense encode, the VPT
prompts (loaded through ``load_params_`` from a CATSeg pytree that carries
``clip.visual.prompt_tokens``) and the synonym-ensembled text run at the
same tolerances; the small-image checks use 64^2 images (grid 4), as
tests/test_clip_parity.py does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catseg_tpu import configs as jconfigs
from catseg_tpu.core import clip as jclip
from catseg_tpu.text.embed import class_embeddings_ensemble as j_ensemble
from catseg_tpu.text.embed import forward_text_embeds as j_text_embeds
from catseg_tpu.text.tokenizer import tokenize
from catseg_tpu.weights.export import export_clip_state_dict

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core import clip as tclip
from catseg_tpu_torch.core.catseg import CATSeg
from catseg_tpu_torch.text.embed import class_embeddings_ensemble as t_ensemble
from catseg_tpu_torch.text.embed import forward_text_embeds as t_text_embeds
from catseg_tpu_torch.weights.from_jax import load_params_

from test_torch_aggregator import mini_cfg_port, mini_params

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


def test_encode_image_not_dense_matches_jax(models):
    """dense=False: the final block runs as a standard block and only the
    CLS token is projected; a tap at the final block sees that output."""
    params, model = models
    imgs = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    jt, jtaps = jclip.encode_image(params, jnp.asarray(imgs), MINI, dense=False, taps=(1, 2))
    with torch.no_grad():
        tt, ttaps = tclip.encode_image(model, torch.from_numpy(imgs), taps=(1, 2), dense=False)
    assert tt.shape == (2, 64) and [t.shape for t in ttaps] == [(2, 17, 128)] * 2
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4, rtol=0)
    for a, b in zip(ttaps, jtaps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


@pytest.mark.parametrize("depth", [2, 3])
def test_vpt_prompt_tokens_match_jax(depth):
    """VPT prompts of length 3 loaded through load_params_: inserted after
    the CLS token for the first min(depth, layers - 1) blocks and stripped
    after each (the taps see stripped outputs); without them the output
    differs."""
    params = mini_params(seed=2)
    rng = np.random.RandomState(9)
    params["clip"]["visual"]["prompt_tokens"] = rng.randn(depth, 3, 128).astype(np.float32) * 0.1
    model = load_params_(CATSeg(mini_cfg_port()), params)
    prompts = model.clip.visual.prompt_tokens
    assert prompts is not None and prompts.shape == (depth, 3, 128)
    imgs = rng.randn(1, 64, 64, 3).astype(np.float32)
    for dense in (False, True):
        jt, jtaps = jclip.encode_image(params["clip"], jnp.asarray(imgs), MINI, dense=dense, taps=(0, 1))
        with torch.no_grad():
            tt, ttaps = tclip.encode_image(model.clip, torch.from_numpy(imgs), taps=(0, 1), dense=dense)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4, rtol=0)
        for a, b in zip(ttaps, jtaps):
            assert a.shape == (1, 17, 128)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    del model.clip.visual.transformer.prompt_tokens
    with torch.no_grad():
        plain = tclip.encode_image(model.clip, torch.from_numpy(imgs))[0]
    assert plain.shape == tt.shape and not torch.allclose(plain, tt, atol=1e-3)


@pytest.mark.parametrize("templates", ["single", "imagenet_select"])
def test_class_embeddings_ensemble_match_jax(models, templates):
    """Synonyms ensembled per template; a single-synonym name keeps the
    forward path's row."""
    params, model = models
    names = NAMES[:3]
    want = j_ensemble(params, names, templates, MINI)
    got = t_ensemble(model, names, templates)
    P = 1 if templates == "single" else 8
    assert got.shape == (3, P, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.norm(dim=-1).numpy(), 1.0, rtol=1e-5)
    fwd = t_text_embeds(model, names, templates)
    torch.testing.assert_close(got[0], fwd[0], atol=1e-6, rtol=0)
    assert not torch.allclose(got[1], fwd[1], atol=1e-3)
