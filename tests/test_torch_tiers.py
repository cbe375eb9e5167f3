"""The encoder tiers beyond ViT-B/16 against catseg_tpu, on the CPU, fp32.

One mini CLIP variant stands for each published tier and keeps the traits
that set it apart from ViT-B/16 (``configs.vitl336`` / ``vith336`` /
``vitg336``): patch 14 for all three; L's 16 heads of 64 (the dense
attention's kernel gate holds) with taps (1, 2) where B's mini taps (0, 1);
H's head dim 80 and exact GELU; G's head dim 104, exact GELU and MLP ratio
4.9231.  Depth, the text tower and the aggregator are cut to the grid-8
mini config of tests/test_catseg_model.py (hidden 32, window 4, 112^2 CLIP
input), with each tier's own widths wired as its preset wires them:
upsample1 / upsample2 from the visual width, the guidance projection and the
cost volume from the embed width.  Parameters: the port's seeded init
converted to a catseg_tpu pytree by catseg_tpu.weights.convert and loaded
into the port by ``load_params_``.  The dense encoders (tokens and both
taps), the text encoder and the whole-image probabilities of one image are
held to max |d| < 5e-4 and mean |d| < 2e-5, the README's oracle bound.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catseg_tpu import configs as jconfigs
from catseg_tpu.core import clip as jclip
from catseg_tpu.infer.pipeline import Predictor as JPredictor
from catseg_tpu.weights.convert import convert_catseg_checkpoint

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
from catseg_tpu_torch.core.clip import encode_image, encode_text
from catseg_tpu_torch.infer.pipeline import Predictor
from catseg_tpu_torch.weights.from_jax import load_params_

# name, patch, width, layers, heads, embed, pretrain_res, text width / heads / layers, vocab, context
TIERS = {
    "L": (dict(name="mini-L/14", patch=14, width=1024, layers=3, heads=16, embed_dim=96, pretrain_res=112,
               text_width=128, text_heads=2, text_layers=2, vocab_size=100, context=16), (1, 2)),
    "H": (dict(name="mini-H-14", patch=14, width=160, layers=3, heads=2, embed_dim=64, pretrain_res=112,
               text_width=80, text_heads=1, text_layers=2, vocab_size=100, context=16, act="gelu"), (1, 2)),
    "G": (dict(name="mini-bigG-14", patch=14, width=208, layers=3, heads=2, embed_dim=80, pretrain_res=112,
               text_width=104, text_heads=1, text_layers=2, vocab_size=100, context=16, act="gelu",
               mlp_ratio=4.9231), (1, 2)),
}


def _cfg(configs, tier):
    kw, taps = TIERS[tier]
    v = configs.CLIPVariant(**kw)
    return configs.CATSegConfig(
        clip=v, clip_resolution=112, guidance_layers=taps, guidance_proj_dim=v.width,
        text_guidance_dim=v.embed_dim, text_guidance_proj_dim=16, appearance_guidance_dim=v.embed_dim,
        appearance_guidance_proj_dim=16, decoder_dims=(32, 16), decoder_guidance_dims=(256, 128),
        decoder_guidance_proj_dims=(8, 4), num_layers=2, num_heads=4, hidden_dim=32, pooling_size=(2, 2),
        feature_resolution=(8, 8), window_size=4, pad_len=12, compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the minis' small ops would each wait on a barrier
    of the whole pool beside JAX's threads and the suite's parallel workers
    (as tests/test_torch_tools.py does)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() < 5e-4 and d.mean() < 2e-5, (d.max(), d.mean())


def test_tier_traits():
    """Each mini variant keeps its tier's head dim, activation and MLP width
    ratio, and the presets wire the widths as the minis do."""
    heads = {t: _cfg(tconfigs, t).clip.width // _cfg(tconfigs, t).clip.heads for t in TIERS}
    assert heads == {"L": 64, "H": 80, "G": 104}
    for tier, preset in (("L", tconfigs.vitl336()), ("H", tconfigs.vith336()), ("G", tconfigs.vitg336())):
        c, p = _cfg(tconfigs, tier), preset.clip
        assert (c.clip.patch, c.clip.act, c.clip.mlp_ratio) == (p.patch, p.act, p.mlp_ratio)
        assert p.width // p.heads == heads[tier] and p.pretrain_grid == 24 == 336 // p.patch
        assert (preset.guidance_proj_dim, preset.appearance_guidance_dim) == (p.width, p.embed_dim)
    assert tconfigs.vitg336().clip.mlp_width == 8192 and _cfg(tconfigs, "G").clip.mlp_width == int(208 * 4.9231)
    for t in TIERS:   # the port's and catseg_tpu's minis are one dataclass apart
        assert dataclasses.asdict(_cfg(tconfigs, t)) == dataclasses.asdict(_cfg(jconfigs, t))


@pytest.fixture(scope="module", params=list(TIERS))
def tier(request):
    """(tier, JAX config, port config, pytree, port model) of one tier."""
    t = request.param
    cfg = _cfg(tconfigs, t)
    sd = {k: v.numpy() for k, v in init_catseg_(CATSeg(cfg), 5).state_dict().items()}
    params = convert_catseg_checkpoint(sd, num_layers=cfg.num_layers)
    return t, _cfg(jconfigs, t), cfg, params, load_params_(CATSeg(cfg), params).eval()


def test_encoders_match_jax(tier):
    """Dense image tokens, both guidance taps and the text embedding."""
    _, jcfg, cfg, params, model = tier
    v = jcfg.clip
    rng = np.random.RandomState(2)
    imgs = rng.randn(2, 112, 112, 3).astype(np.float32)
    tokens = np.zeros((3, v.context), np.int64)
    for i, n in enumerate((5, 9, 16)):
        tokens[i, :n] = rng.randint(1, v.vocab_size - 1, n)
        tokens[i, n - 1] = v.vocab_size - 1   # EOT, the largest id

    # one jitted call: eager dispatch of the interpreted attention kernel costs more than the compile
    @jax.jit
    def encode(p, x, t):
        return jclip.encode_image(p, x, v, dense=True, taps=jcfg.guidance_layers), jclip.encode_text(p, t, v)

    (want, want_taps), want_text = encode(params["clip"], jnp.asarray(imgs), jnp.asarray(tokens.astype(np.int32)))
    with torch.no_grad():
        got, got_taps = encode_image(model.clip, torch.from_numpy(imgs), cfg.guidance_layers)
        got_text = encode_text(model.clip, torch.from_numpy(tokens))
    assert got.shape == (2, 65, v.embed_dim) and got_taps[0].shape == (2, 65, v.width)
    _close(got.numpy(), want)
    for g, w in zip(got_taps, want_taps, strict=True):
        _close(g.numpy(), w)
    _close(got_text.numpy(), want_text)


def test_whole_image_probs_match_jax(tier):
    """The whole-image branch of one 150x200 image (zero-padded to 384^2,
    resized to 112^2) with 5 random unit text features."""
    t, jcfg, cfg, params, model = tier
    rng = np.random.RandomState(3)
    image = rng.randint(0, 256, (150, 200, 3), dtype=np.uint8)
    text = rng.randn(5, 1, cfg.clip.embed_dim).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    names = [f"c{i}" for i in range(5)]
    want = JPredictor(params, jcfg, names, text_feats=text).probs_whole(image)
    got = Predictor(model, cfg, names, text_feats=text, device="cpu").probs_whole(image)
    assert got.shape == (32, 32, 5)
    _close(got.numpy(), want)

