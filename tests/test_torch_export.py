"""The port's runtime-size serving functions and its ``torch.export``
artifact, on the CPU, against catseg_tpu's.

- ``bilinear_row_weights_dynamic{,_out}``: within 1e-7 of catseg_tpu's.
- ``canvas_to_sliding_inputs`` within 1e-4 (0-255 pixels, fp32 sums);
  ``sliding_window_probs_from_canvas`` at the mini flagship config of
  test_torch_aggregator.py (fp32, T = 6) within 5e-4 max / 2e-5 mean (the
  bound of tests/test_torch_pipeline.py); ``resize_argmax_dynamic`` equal
  to catseg_tpu's on fp32 probabilities over several class chunks.
- The artifact (``infer.export``) bit-equal to the live serve module at two
  true sizes, its graph holding the ``catseg_tpu_torch::`` ops of the path;
  ``tools.export --check`` prints "check OK".
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catseg_tpu.infer import pipeline as jpipe
from catseg_tpu.ops import resize as jresize
from catseg_tpu.text.embed import forward_text_embeds as j_text

from catseg_tpu_torch.core.catseg import CATSeg, compute_dtype
from catseg_tpu_torch.infer import export as texport
from catseg_tpu_torch.infer import pipeline as tpipe
from catseg_tpu_torch.ops import resize as tresize
from catseg_tpu_torch.text.embed import forward_text_embeds
from catseg_tpu_torch.tools import common
from catseg_tpu_torch.tools import export as export_cli
from catseg_tpu_torch.weights.from_jax import load_params_

from test_torch_aggregator import mini_cfg, mini_cfg_port, mini_params

NAMES = ["wall", "building, edifice", "sky", "floor, flooring", "tree", "ceiling"]
CANVAS = (160, 192)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads, as the other port files beside the suite's workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("out,insz,pad,valid", [(640, 480, 1024, None), (384, 683, 1024, None),
                                                (96, 100, 128, 50), (7, 3, 8, 7), (640, 1024, 1024, 600)])
def test_row_weights_dynamic_match(out, insz, pad, valid):
    want = np.asarray(jresize.bilinear_row_weights_dynamic(out, jnp.int32(insz), pad,
                                                           None if valid is None else jnp.int32(valid)))
    got = tresize.bilinear_row_weights_dynamic(out, torch.tensor(insz, dtype=torch.int32), pad,
                                               None if valid is None else torch.tensor(valid, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-7


@pytest.mark.parametrize("rows,outsz,insz", [(768, 512, 640), (768, 700, 640), (16, 5, 7), (640, 640, 640)])
def test_row_weights_dynamic_out_match(rows, outsz, insz):
    want = np.asarray(jresize.bilinear_row_weights_dynamic_out(rows, jnp.int32(outsz), insz))
    got = tresize.bilinear_row_weights_dynamic_out(rows, torch.tensor(outsz, dtype=torch.int32), insz)
    assert got.shape == want.shape and np.abs(got.numpy() - want).max() <= 1e-7


def test_resize_argmax_dynamic_matches():
    rng = np.random.RandomState(3)
    probs = rng.rand(40, 52, 70).astype(np.float32)    # three chunks of 32 classes, the last partial
    for out_hw in ((37, 61), (64, 80)):
        want = np.asarray(jpipe.resize_argmax_dynamic(jnp.asarray(probs), jnp.asarray(out_hw, jnp.int32), (64, 80)))
        got = tpipe.resize_argmax_dynamic(torch.from_numpy(probs), torch.tensor(out_hw, dtype=torch.int32), (64, 80))
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        assert not got[out_hw[0]:].any() and not got[:, out_hw[1]:].any()


@pytest.fixture(scope="module")
def setup():
    params = mini_params(seed=1)
    cfg = mini_cfg_port()
    model = load_params_(CATSeg(cfg), params).eval()
    with torch.inference_mode():
        tf = forward_text_embeds(model.clip, NAMES, cfg.prompt_ensemble_type, compute_dtype=compute_dtype(cfg))
    return params, model, tf.clone()


def _canvas(h, w, seed):
    canvas = np.zeros(CANVAS + (3,), np.uint8)
    canvas[:h, :w] = np.random.RandomState(seed).randint(0, 256, (h, w, 3), dtype=np.uint8)
    return canvas


def test_canvas_inputs_and_probs_match_jax(setup):
    params, model, tf = setup
    jtf = j_text(params["clip"], NAMES, mini_cfg().prompt_ensemble_type, mini_cfg().clip)
    canvas, hw = _canvas(120, 150, 0), np.array([120, 150], np.int32)
    want_in = jpipe.canvas_to_sliding_inputs(jnp.asarray(canvas), jnp.asarray(hw), mini_cfg())
    got_in = tpipe.canvas_to_sliding_inputs(torch.from_numpy(canvas), torch.from_numpy(hw), mini_cfg_port())
    for g, w in zip(got_in, want_in):
        assert g.shape == w.shape and np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4
    want = np.asarray(jpipe.sliding_window_probs_from_canvas(params, jnp.asarray(canvas), jnp.asarray(hw), jtf,
                                                             mini_cfg()))
    with torch.inference_mode():
        got = tpipe.sliding_window_probs_from_canvas(model, torch.from_numpy(canvas), torch.from_numpy(hw), tf,
                                                     mini_cfg_port()).numpy()
    assert got.shape == want.shape == (640, 640, len(NAMES))
    d = np.abs(got - want)
    assert d.max() < 5e-4 and d.mean() < 2e-5, (d.max(), d.mean())


def test_artifact_equals_live_serving(setup, tmp_path):
    _, model, tf = setup
    cfg = mini_cfg_port(fused_decoder=True)   # the decoder op on the path too
    spec = texport.ExportSpec(CANVAS, (128, 160), len(NAMES))
    path = str(tmp_path / "serve.pt2")
    exported = texport.export_serving(model, cfg, tf, spec, path)
    ops = {str(n.target).split(".")[1] for n in exported.graph.nodes if str(n.target).startswith("catseg_tpu_torch.")}
    assert ops == {"layer_norm", "dense_attention", "corr_embed", "swin_block", "class_layer", "decoder"}
    assert not any(k.startswith("model.sem_seg_head.predictor.clip_model.transformer.") for k in exported.state_dict)
    artifact = texport.load_exported(path)
    serve = texport.make_serve_fn(model, cfg, tf, spec)
    for (h, w), out_hw, seed in (((120, 150), (96, 128), 1), ((160, 100), (128, 160), 2)):
        canvas, hw = _canvas(h, w, seed), np.array([h, w], np.int32)
        got = artifact(canvas, hw, np.array(out_hw, np.int32))
        with torch.inference_mode():
            want = serve(torch.from_numpy(canvas), torch.from_numpy(hw), torch.tensor(out_hw, dtype=torch.int32))
        assert got.shape == (128, 160) and got.dtype == torch.int32 and torch.equal(got, want)
        assert not got[out_hw[0]:].any() and not got[:, out_hw[1]:].any()
    # the caller's model keeps its text tower
    assert len(model.clip.transformer.resblocks) == cfg.clip.text_layers


def test_export_cli_check(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(common.PRESETS, "mini", mini_cfg_port)
    out = export_cli.main(["--device", "cpu", "--config", "mini", "--classes", "sky,tree,road", "--canvas", "96x128",
                           "--out-canvas", "64x96", "--output", str(tmp_path / "m.pt2"), "--check"])
    printed = capsys.readouterr().out
    assert "check OK" in printed and out["check"] and out["mb"] > 0
