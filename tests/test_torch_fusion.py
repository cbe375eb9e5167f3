"""The fork's dual-encoder families in the port against catseg_tpu, on the CPU, fp32.

Mini configs on the grid-8 aggregator of tests/test_torch_tiers.py (hidden
32, window 4, 4 heads, decoder dims (32, 16)), pad_len 8:

- Ver31 (``fusion_ver31``, text guidance zeroed as the preset does): a mini
  CLIP with patch 32 at the fusion CLIP resolution 256 (its 7x7 pretrain
  grid resized to 8x8) and a mini DINO, patch 8 at 2 layers, width 32, run
  at 128^2 (grid 16 from a pretrain grid of 4, so the positional resize
  runs; the stride-2 down-sample conv to the 8x8 grid);
- Ver14 (``fusion_ver14``): a mini CLIP with patch 16 at 128^2 and the mini
  SAM of tests/test_torch_sam.py at 80^2 (grid 5: a window of 2 pads it to
  6, a global block resizes its rel-pos tables and the positional grid).

Parameters: the port's seeded init with every weight redrawn at a scale
that keeps activations O(1) (:func:`params`), converted to a catseg_tpu
pytree by catseg_tpu.weights.convert and loaded into the port by
``load_params_``.  Inputs come from numpy seeds.  Logits and probabilities
are held to max |d| < 5e-4 and mean |d| < 2e-5 (the README's oracle bound);
the converter and exporter round trips bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catseg_tpu import configs as jconfigs
from catseg_tpu.core import dino as jdino
from catseg_tpu.core import sam as jsam
from catseg_tpu.core.fusion import fusion_forward as j_fusion_forward
from catseg_tpu.infer.pipeline import Predictor as JPredictor
from catseg_tpu.weights import convert as jconvert
from catseg_tpu.weights.export import export_catseg_checkpoint as j_export

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core import dino as tdino
from catseg_tpu_torch.core import sam as tsam
from catseg_tpu_torch.core.catseg import build_catseg, model_class
from catseg_tpu_torch.core.fusion import DualEncoderCATSeg, SAMRefineCATSeg
from catseg_tpu_torch.infer.pipeline import Predictor
from catseg_tpu_torch.tools import common
from catseg_tpu_torch.weights import convert
from catseg_tpu_torch.weights.export import export_catseg_checkpoint as t_export
from catseg_tpu_torch.weights.from_jax import load_params_, state_dict_from_params

DINO_MINI = dict(patch=8, width=32, layers=2, heads=2, pretrain_grid=4)
SAM_MINI = dict(img_size=64, patch=16, width=32, layers=2, heads=2, out_chans=32, window=2, global_blocks=(1,))
NAMES = ["wall", "building, edifice", "sky", "floor, flooring", "tree", "ceiling"]


def register_minis() -> None:
    """The mini DINO and SAM variants in both packages' variant tables, as
    catseg_tpu's own tests register theirs."""
    for dmod, smod in ((jdino, jsam), (tdino, tsam)):
        dmod.DINO_VARIANTS["torch_mini_dino"] = dmod.DINOVariant(**DINO_MINI)
        smod.SAM_VARIANTS["torch_mini_sam"] = smod.SAMVariant(**SAM_MINI)


def fusion_cfg(configs, family: str, **fusion_kw):
    """The mini config of ``family`` ("ver31" / "ver14") as ``configs``' dataclass."""
    register_minis()
    base = dict(guidance_layers=(0, 1), appearance_guidance_proj_dim=16, decoder_dims=(32, 16),
                decoder_guidance_proj_dims=(8, 4), num_heads=4, hidden_dim=32, feature_resolution=(8, 8),
                window_size=4, pad_len=8, compute_dtype="float32")
    if family == "ver31":
        clip = configs.CLIPVariant("mini-B/32", 32, 128, 3, 2, 64, 224, 128, 2, 2)
        fus = dict(encoder="torch_mini_dino", encoder_resolution=128, clip_resolution=256,
                   guidance_blocks=(0, 1))
        fus.update(fusion_kw)
        return configs.fusion_ver31(clip=clip, guidance_proj_dim=128, appearance_guidance_dim=64,
                                    fusion=configs.FusionConfig(**fus), **base)
    clip = configs.CLIPVariant("mini-B/16", 16, 128, 3, 2, 64, 224, 128, 2, 2)
    fus = dict(mode="sam_refine", encoder="torch_mini_sam", encoder_resolution=80, clip_resolution=128,
               refine_chunk=4)
    fus.update(fusion_kw)
    return configs.fusion_ver14(clip=clip, guidance_proj_dim=128, text_guidance_dim=64, text_guidance_proj_dim=16,
                                appearance_guidance_dim=64, fusion=configs.FusionConfig(**fus), **base)


def params(family: str, seed: int = 0) -> dict:
    """A catseg_tpu pytree for the mini ``family``: the port's seeded state
    dict with every tensor redrawn from a numpy seed (weights at
    1/sqrt(fan_in), norms 1 + N(0, 0.1), the rest N(0, 0.1); the SAM
    modules' and DINO's weights twice that, so their outputs are O(1)), then
    catseg_tpu's converter."""
    cfg = fusion_cfg(tconfigs, family)
    sd = {k: v.numpy() for k, v in model_class(cfg)(cfg).state_dict().items()}
    rng = np.random.RandomState(seed)
    for k, v in sd.items():
        if k.endswith("positional_encoding_gaussian_matrix"):
            sd[k] = rng.randn(*v.shape).astype(np.float32)
        elif v.ndim >= 2 and not k.endswith(("embedding", "embed", "token", "tokens", "rel_pos_h", "rel_pos_w")):
            scale = 2.0 if k.startswith(("sam_", "dino_model.")) else 1.0
            sd[k] = (rng.randn(*v.shape) * scale * (v.size // v.shape[0]) ** -0.5).astype(np.float32)
        else:
            norm = k.endswith("weight") and v.ndim == 1
            sd[k] = np.asarray(float(norm) + rng.randn(*v.shape) * 0.1, np.float32)
    return jconvert.convert_catseg_checkpoint(sd, num_layers=cfg.num_layers)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the minis' small ops would each wait on a barrier
    of the whole pool beside JAX's threads and the suite's parallel workers
    (as tests/test_torch_tools.py does)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees():
    return {f: params(f) for f in ("ver31", "ver14")}


def close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.max() < 5e-4 and d.mean() < 2e-5, (d.max(), d.mean())


def _model(family, tree, **fusion_kw):
    cfg = fusion_cfg(tconfigs, family, **fusion_kw)
    return load_params_(model_class(cfg)(cfg), tree).eval(), cfg, fusion_cfg(jconfigs, family, **fusion_kw)


def _forward_case(tree, family, T, seed, **fusion_kw):
    model, cfg, jcfg = _model(family, tree, **fusion_kw)
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (2, 96, 96, 3)).astype(np.float32)
    text = rng.randn(T, 1, 64).astype(np.float32)
    want = jax.jit(lambda p, i, t: j_fusion_forward(p, i, t, jcfg))(tree, jnp.asarray(imgs), jnp.asarray(text))
    with torch.inference_mode():
        got = model(torch.from_numpy(imgs), torch.from_numpy(text))
    return got.numpy(), np.asarray(want)


def test_ver31_topk_forward_matches_jax(trees):
    """fusion_forward, mode "corr", from raw tiles at T = 11 > pad_len 8:
    each volume keeps its own top-k, the logits scatter by the CLIP
    volume's (T <= pad_len: test_predictor_matches_jax)."""
    got, want = _forward_case(trees["ver31"], "ver31", 11, seed=11)
    assert got.shape == (2, 11, 32, 32)
    assert ((got == -100.0).all(axis=(2, 3)).sum(1) == 3).all()
    assert np.abs(want).max() > 1.0
    close(got, want)


@pytest.mark.parametrize("flags", [(True, False), (False, True), (False, False)],
                         ids=["second_corr", "dual_guidance", "neither"])
def test_ver31_fusion_point_flags_match_jax(trees, flags):
    """second_corr / dual_guidance off drop the second volume (the plain
    single-volume embed) or the second guidance pyramid; with both off DINO
    does not run (its weights may be anything)."""
    second_corr, dual_guidance = flags
    tree = trees["ver31"]
    if flags == (False, False):
        tree = dict(tree, dino=jax.tree.map(lambda a: np.full_like(a, np.nan), tree["dino"]))
    got, want = _forward_case(tree, "ver31", 11, seed=5, second_corr=second_corr, dual_guidance=dual_guidance)
    assert np.isfinite(got).all()
    close(got, want)


@pytest.mark.parametrize("refine_from", ["raw_corr", "head"])
def test_ver14_topk_forward_matches_jax(trees, refine_from):
    """Ver14 refined logits (B, T, 20, 20) from raw-corr or head proposals at
    T = 11 > pad_len 8: the top-k classes are refined, the rest get -100;
    refine_chunk 4 over 2 images: 2 classes an image a step, the 8 kept
    classes in 4 steps (T <= pad_len: test_predictor_matches_jax)."""
    T = 11
    got, want = _forward_case(trees["ver14"], "ver14", T, seed=T, refine_from=refine_from)
    assert got.shape == (2, T, 20, 20)
    assert np.abs(want[want > -100]).max() > 1.0
    close(got, want)


@pytest.mark.parametrize("family,branch", [("ver31", "sliding"), ("ver31", "whole"), ("ver14", "sliding"),
                                           ("ver14", "whole")])
def test_predictor_matches_jax(trees, family, branch):
    """One Predictor per family and branch: the sliding batch (raw 384^2
    tiles, the second encoder's input derived from each CLIP image) and the
    whole-image canvas (the padded image resized to each encoder's
    resolution on its own)."""
    model, cfg, jcfg = _model(family, trees[family])
    if branch == "sliding":
        cfg, jcfg = tconfigs.eval_preset(cfg), jconfigs.eval_preset(jcfg)
    rng = np.random.RandomState(7)
    im = rng.randint(0, 256, (100, 150, 3), dtype=np.uint8)
    text = rng.randn(len(NAMES), 1, 64).astype(np.float32)
    jp = JPredictor(trees[family], jcfg, NAMES, text_feats=jnp.asarray(text))
    tp = Predictor(model, cfg, NAMES, text_feats=text, device="cpu")
    got = tp.probs(im)
    side = {"sliding": 640, "whole": 32 if family == "ver31" else 20}[branch]
    assert got.shape == (side, side, len(NAMES))
    close(got.numpy(), jp.probs(im))
    if branch == "sliding":
        close(tp.probs_sliding_batch([im, im[:80]])[1].numpy(), jp.probs(im[:80]))


@pytest.mark.parametrize("family", ["ver31", "ver14"])
def test_converter_and_exporter_round_trip_bit_equal(trees, family):
    """A fork-named checkpoint (catseg_tpu's export of the pytree): the
    port's converter gives catseg_tpu's converter's result bit for bit, the
    port's exporter gives catseg_tpu's exporter's, and the port's model
    loads it strictly and exports back the same."""
    sd = j_export(trees[family])
    sd["sem_seg_head.predictor.transformer.layers.0.swin_block.block_2.attn_mask"] = np.zeros((4, 16, 16))
    want = state_dict_from_params(jconvert.convert_catseg_checkpoint(sd))
    got = convert.convert_catseg_checkpoint({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    mine = t_export(trees[family])
    assert set(mine) == set(j_export(trees[family]))
    assert all(np.array_equal(mine[k], v) for k, v in j_export(trees[family]).items())
    cfg = fusion_cfg(tconfigs, family)
    model = model_class(cfg)(cfg)
    model.load_state_dict(got, strict=True)
    assert all(torch.equal(v, got[k]) for k, v in model.state_dict().items())


def test_presets_build_their_family(tmp_path, trees):
    """The presets resolve through tools.common; build_catseg and load_params
    (seeded, .npz and a fork-named .pth) give each family's module."""
    assert common.resolve_config("fusion_ver31", []) == tconfigs.fusion_ver31()
    assert common.resolve_config("fusion_ver14", ["compute_dtype=float32"]) == tconfigs.fusion_ver14(
        compute_dtype="float32")
    for family, cls in (("ver31", DualEncoderCATSeg), ("ver14", SAMRefineCATSeg)):
        cfg = fusion_cfg(tconfigs, family)
        a, b = build_catseg(cfg, seed=3, device="cpu"), common.load_params(None, cfg, seed=3, device="cpu")
        assert type(a) is cls and type(b) is cls
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
        path = str(tmp_path / f"{family}.pth")
        torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in j_export(trees[family]).items()}}, path)
        got = common.load_params(path, cfg, device="cpu").state_dict()
        want = state_dict_from_params(trees[family])
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_dino_intermediate_layers_match_jax(trees):
    """get_intermediate_layers at 64^2 (grid 8 from the pretrain grid 4; the
    final norm on every block), fp32, against catseg_tpu's."""
    register_minis()
    model, _, _ = _model("ver31", trees["ver31"])
    imgs = np.random.RandomState(11).randn(2, 64, 64, 3).astype(np.float32)
    want = jdino.get_intermediate_layers(trees["ver31"]["dino"], jnp.asarray(imgs),
                                         jdino.DINO_VARIANTS["torch_mini_dino"], n=2)
    with torch.inference_mode():
        got = tdino.get_intermediate_layers(model.dino_model, torch.from_numpy(imgs))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (2, 65, 32)
        close(g.numpy(), w)
