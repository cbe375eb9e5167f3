"""The port's SAM modules against catseg_tpu's, on the CPU, fp32.

The mini SAM of tests/test_torch_fusion.py (patch 16, width 32, 2 blocks
of 2 heads, window 2, block 1 global, 32 output channels; its tables sized
for 64^2) runs at 80^2: grid 5, so each windowed block pads it to 6, the
global block resizes its rel-pos tables from 7 to 9 rows and the
positional embedding from 4x4 to 5x5.  The prompt encoder and the
two-layer mask decoder are the Ver14 mini model's (dim 32, 8 heads).
Parameters are test_torch_fusion.params("ver14") (catseg_tpu's converter),
loaded into the port by ``load_params_``; inputs come from numpy seeds.
Held to max |d| < 5e-4 and mean |d| < 2e-5, the README's oracle bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catseg_tpu.core import sam as jsam
from catseg_tpu.core import sam_decoder as jdec
from catseg_tpu.core.fusion import sam_mask_refine as j_sam_mask_refine

from catseg_tpu_torch.core import sam as tsam
from catseg_tpu_torch.core.catseg import model_class
from catseg_tpu_torch.core.fusion import sam_mask_refine
from catseg_tpu_torch.core.sam_decoder import dense_pe
from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.weights.from_jax import load_params_

from test_torch_fusion import close, fusion_cfg, params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as tests/test_torch_fusion.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ver14():
    """(catseg_tpu pytree, the port's model) of the mini Ver14 family."""
    tree = params("ver14", seed=1)
    cfg = fusion_cfg(tconfigs, "ver14")
    return tree, load_params_(model_class(cfg)(cfg), tree).eval()


def _sam_feat(seed: int, B: int = 2) -> np.ndarray:
    return np.random.RandomState(seed).randn(B, 5, 5, 32).astype(np.float32)


def test_sam_encoder_matches_jax(ver14):
    """encode_image at 80^2: padded windows, a global block with resized
    rel-pos tables, the resized positional grid, the LayerNorm2d neck."""
    tree, model = ver14
    imgs = np.random.RandomState(2).randn(2, 80, 80, 3).astype(np.float32)
    variant = jsam.SAM_VARIANTS["torch_mini_sam"]
    want = jax.jit(lambda p, x: jsam.encode_image(p, x, variant))(tree["sam"], jnp.asarray(imgs))
    with torch.inference_mode():
        got = model.sam_encoder(torch.from_numpy(imgs))
    assert got.shape == (2, 5, 5, 32)
    assert np.abs(np.asarray(want)).max() > 0.5
    close(got.numpy(), want)


def test_rel_pos_and_window_padding_match_jax():
    """get_rel_pos (a 7-row table resized to 9 rows, and at its own size)
    and the padded window partition round trip."""
    table = np.random.RandomState(3).randn(7, 16).astype(np.float32)
    for size in (4, 5):
        close(tsam.get_rel_pos(size, size, torch.from_numpy(table)).numpy(),
              jsam._get_rel_pos(size, size, jnp.asarray(table)))
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 5, 5, 3).astype(np.float32))
    wins, pad_hw = tsam.window_partition_pad(x, 2)
    jwins, jpad = jsam._window_partition_pad(jnp.asarray(x.numpy()), 2)
    assert pad_hw == jpad == (6, 6) and wins.shape == (18, 2, 2, 3)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jwins))
    assert torch.equal(tsam.window_unpartition(wins, 2, pad_hw, (5, 5)), x)


@pytest.mark.parametrize("multimask", [False, True], ids=["single", "multimask"])
def test_mask_decoder_matches_jax(ver14, multimask):
    """The two-way transformer and mask decoder on an image embedding and
    dense mask prompts with point and box prompts as the sparse tokens;
    the IoU head too."""
    tree, model = ver14
    rng = np.random.RandomState(5)
    feat = _sam_feat(6)
    masks = rng.randn(2, 20, 20, 1).astype(np.float32)
    points = rng.uniform(0, 80, (2, 3, 2)).astype(np.float32)
    labels = np.array([[1, 0, -1], [0, 1, 1]], np.int32)
    boxes = np.array([[4.0, 6.0, 50.0, 70.0], [10.0, 2.0, 30.0, 44.0]], np.float32)
    pe, dec = tree["sam_pe"], tree["sam_dec"]
    j_sparse = jnp.concatenate([jdec.embed_points(pe, jnp.asarray(points), jnp.asarray(labels), (80, 80)),
                                jdec.embed_boxes(pe, jnp.asarray(boxes), (80, 80))], axis=1)
    j_dense = jdec.embed_masks(pe, jnp.asarray(masks))
    want = jax.jit(lambda *a: jdec.mask_decoder(*a, multimask_output=multimask))(
        dec, jnp.asarray(feat), jdec.dense_pe(pe["gauss"], (5, 5)), j_sparse, j_dense)
    tpe, tdec = model.sam_prompt_encoder, model.sam_decoder
    with torch.inference_mode():
        sparse = torch.cat([tpe.embed_points(torch.from_numpy(points), torch.from_numpy(labels), (80, 80)),
                            tpe.embed_boxes(torch.from_numpy(boxes), (80, 80))], dim=1)
        close(sparse.numpy(), j_sparse)
        dense = tpe.embed_masks(torch.from_numpy(masks))
        close(dense.numpy(), j_dense)
        got = tdec(torch.from_numpy(feat), dense_pe(tpe.gauss, (5, 5)), sparse, dense, multimask_output=multimask)
    n = 3 if multimask else 1
    assert got[0].shape == (2, n, 20, 20) and got[1].shape == (2, n)
    assert np.abs(np.asarray(want[0])).max() > 1.0
    for g, w in zip(got, want):
        close(g.numpy(), w)


@pytest.mark.parametrize("T,chunk", [(4, 4), (7, 4), (3, 16)], ids=["T4-chunk4", "T7-chunk4", "T3-chunk16"])
def test_sam_mask_refine_matches_jax(ver14, T, chunk):
    """sam_mask_refine: nearest upsampling of 8x8 proposals to the 20x20
    prompt grid, classes chunk // B per image a step (T = 7 pads the class
    axis to 8 and strips it; chunk 16 runs all 3 classes of both images in
    one step)."""
    tree, model = ver14
    coarse = np.random.RandomState(T).randn(2, T, 8, 8).astype(np.float32) * 3
    feat = _sam_feat(8)
    want = jax.jit(lambda *a: j_sam_mask_refine(*a, chunk=chunk))(
        tree["sam"], tree["sam_pe"], tree["sam_dec"], jnp.asarray(coarse), jnp.asarray(feat))
    with torch.inference_mode():
        got = sam_mask_refine(model.sam_prompt_encoder, model.sam_decoder, torch.from_numpy(coarse),
                              torch.from_numpy(feat), chunk=chunk)
    assert got.shape == (2, T, 20, 20)
    close(got.numpy(), want)
