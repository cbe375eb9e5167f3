"""The port's serving tools on the CPU: CLIP attention maps against
catseg_tpu's, and the ``tools.viz_attn`` / ``tools.demo`` CLIs end to end.

Config: the mini flagship config of test_torch_aggregator.py (fp32, T = 6),
registered as a ``mini`` preset (seeded weights, as the CLIs build them).
- ``encode_image_attn_maps``: within 1e-5 of catseg_tpu's at the mini CLIP
  (3 layers, 2 heads of 64, 384^2), rows summing to 1 within 1e-5.
- ``tools.viz_attn``: one grey PNG per layer, the reference's ``head_grid``
  of the port's maps.
- ``tools.demo``: overlays under the inputs' names and the top classes
  printed, with ``--classes`` and ``--class-json``; ``--parallel`` gives the
  sequential run's argmax maps exactly; ``--video-input`` without OpenCV
  exits naming cv2; ``--shard-tiles`` on one device prints the reference's
  note.
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from catseg_tpu.core.clip import encode_image_attn_maps as j_attn_maps
from catseg_tpu.tools.viz_attn import head_grid as j_head_grid

from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
from catseg_tpu_torch.core.clip import encode_image_attn_maps
from catseg_tpu_torch.tools import common
from catseg_tpu_torch.tools import demo as demo_cli
from catseg_tpu_torch.tools import viz_attn as viz_attn_cli
from catseg_tpu_torch.weights.from_jax import load_params_

from test_torch_aggregator import mini_cfg_port, mini_params


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the mini model's many small ops, as test_torch_tools.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("layers", [(0, 2), (1,)])
def test_attention_maps_match_jax(layers):
    params = mini_params(seed=2)
    cfg = mini_cfg_port()
    model = load_params_(CATSeg(cfg), params).eval()
    images = np.random.RandomState(4).randn(2, 384, 384, 3).astype(np.float32)
    want = j_attn_maps(params["clip"], jnp.asarray(images), cfg.clip, attn_layers=layers)
    with torch.inference_mode():
        got = encode_image_attn_maps(model.clip, torch.from_numpy(images), attn_layers=layers)
    assert len(got) == len(want) == len(layers)
    for g, w in zip(got, want):
        assert g.shape == (2, 2, 577, 577) and g.dtype == torch.float32
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-5
        assert (g.sum(-1) - 1).abs().max() <= 1e-5


@pytest.fixture
def mini_preset(monkeypatch):
    monkeypatch.setitem(common.PRESETS, "mini", mini_cfg_port)


@pytest.fixture
def inputs(tmp_path):
    rng = np.random.RandomState(0)
    paths = []
    for i, (h, w) in enumerate([(60, 80), (50, 70)]):
        p = tmp_path / f"in{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    return paths


def test_viz_attn_cli(mini_preset, inputs, tmp_path, capsys):
    out = tmp_path / "attn"
    written = viz_attn_cli.main(["--device", "cpu", "--config", "mini", "--input", inputs[0], "--layers", "2,0",
                                 "--output", str(out)])
    assert [p.rsplit("/", 1)[1] for p in written] == ["in0_layer0_heads.png", "in0_layer2_heads.png"]
    model = init_catseg_(CATSeg(mini_cfg_port()), 0).eval()
    from catseg_tpu_torch.data.loader import load_image

    maps = viz_attn_cli.attention_maps(model, mini_cfg_port(), load_image(inputs[0]), (0, 2))
    for path, attn in zip(written, maps):
        grid = np.asarray(Image.open(path))
        assert grid.dtype == np.uint8 and grid.shape == (24 * 8, 2 * 24 * 8)
        assert np.array_equal(grid, j_head_grid(attn[0].numpy(), 24))
    assert "layer 2:" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="out of range"):
        viz_attn_cli.main(["--device", "cpu", "--config", "mini", "--input", inputs[0], "--layers", "3"])


def test_demo_cli(mini_preset, inputs, tmp_path, capsys):
    names = ["wall", "sky", "tree", "road", "person"]
    (tmp_path / "names.json").write_text(json.dumps(names))
    run = demo_cli.main(["--device", "cpu", "--config", "mini", "--input", *inputs, "--output",
                         str(tmp_path / "a"), "--classes", ",".join(names), "--shard-tiles"])
    seq = run["preds"]
    printed = capsys.readouterr().out
    assert "only one device visible" in printed and printed.count("top classes:") == 2
    assert "2 images, " in printed and run["ms_per_image"] > 0
    for p in inputs:
        vis = np.asarray(Image.open(tmp_path / "a" / p.rsplit("/", 1)[1]))
        assert vis.shape == np.asarray(Image.open(p)).shape
        assert seq[p].shape == vis.shape[:2] and seq[p].min() >= 0 and seq[p].max() < len(names)
    par = demo_cli.main(["--device", "cpu", "--config", "mini", "--input", *inputs, "--output",
                         str(tmp_path / "b"), "--class-json", str(tmp_path / "names.json"), "--parallel"])["preds"]
    assert "top classes:" in capsys.readouterr().out
    for p in inputs:
        assert np.array_equal(par[p], seq[p])


def test_demo_video_needs_cv2(mini_preset, tmp_path):
    with pytest.raises(SystemExit, match="cv2"):
        demo_cli.main(["--device", "cpu", "--config", "mini", "--video-input", str(tmp_path / "v.mp4"),
                       "--classes", "sky,tree"])
