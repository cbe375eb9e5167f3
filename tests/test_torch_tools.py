"""The port's eval and train CLIs end to end on the CPU (``--device cpu``).

Config: the mini flagship config of test_torch_aggregator.py registered as
a ``mini`` preset (fp32, T = 6); data: a synthetic dataset of JPEG images
and PNG label maps written here.  ``tools.eval`` prints its copypaste line
and writes its --output JSON (with the gzero split); ``tools.train`` takes
two steps through the mapper and the prefetch thread, leaves a resumable
checkpoint, resumes from it, and ``tools.eval --checkpoint`` reads its
``model_final.pth``.  Also: the weight loaders and the refused presets.
"""

import functools
import json

import numpy as np
import pytest
import torch
from PIL import Image

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
from catseg_tpu_torch.data import catalogs
from catseg_tpu_torch.tools import common
from catseg_tpu_torch.tools import eval as eval_cli
from catseg_tpu_torch.tools import train as train_cli
from catseg_tpu_torch.train import loop as train_loop
from catseg_tpu_torch.weights import io as wio

from test_torch_aggregator import mini_cfg_port, mini_params

NAMES = ["wall", "building, edifice", "sky", "floor, flooring", "tree", "ceiling"]


def _mini_train(**kw):
    base = dict(clip=tconfigs.CLIPVariant("mini-B/16", 16, 128, 3, 2, 64, 224, 128, 2, 2),
                guidance_layers=(0, 1), guidance_proj_dim=128, text_guidance_dim=64,
                appearance_guidance_dim=64, pad_len=8, compute_dtype="float32", batch_size=2)
    base.update(kw)
    return tconfigs.vitb384(**base)



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the mini model's many small ops would each wait on
    a barrier of the whole pool, which stalls when the suite's parallel
    workers oversubscribe the cores (as tests/test_torch_train.py does)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

@pytest.fixture
def data(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    for split in ("val", "train"):
        (tmp_path / "imgs" / split).mkdir(parents=True)
        (tmp_path / "gts" / split).mkdir(parents=True)
        for i, (h, w) in enumerate([(100, 130), (121, 97), (90, 140)]):
            Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(
                tmp_path / "imgs" / split / f"im{i}.jpg")
            gt = rng.randint(0, len(NAMES), (h, w)).astype(np.uint8)
            gt[:10] = 255
            Image.fromarray(gt).save(tmp_path / "gts" / split / f"im{i}.png")
    (tmp_path / "mini_classes.json").write_text(json.dumps(NAMES))
    for split in ("val", "train"):
        monkeypatch.setitem(catalogs.DATASETS, f"mini_{split}", catalogs.DatasetSpec(
            f"mini_{split}", f"imgs/{split}", f"gts/{split}", "mini_classes.json", len(NAMES), 255))
    monkeypatch.setattr(catalogs, "_class_json_search", lambda: (str(tmp_path),))
    monkeypatch.setitem(common.PRESETS, "mini", mini_cfg_port)
    monkeypatch.setitem(common.PRESETS, "mini_train", _mini_train)
    return tmp_path


def test_eval_cli_end_to_end(data, tmp_path, capsys):
    (tmp_path / "seen.json").write_text(json.dumps([0, 1, 2]))
    (tmp_path / "unseen.json").write_text(json.dumps([3, 4, 5]))
    out = tmp_path / "m.json"
    full = eval_cli.main(["--device", "cpu", "--config", "mini", "--benchmarks", "mini_val", "--data-root",
                          str(data), "--output", str(out), "--seen-indexes", str(tmp_path / "seen.json"),
                          "--unseen-indexes", str(tmp_path / "unseen.json"), "--limit", "2"])
    stdout = capsys.readouterr().out
    assert "copypaste: mini_val: mIoU=" in stdout and "copypaste-gzero: mini_val: seen=" in stdout
    m = json.loads(out.read_text())["mini_val"]
    assert m["num_images"] == 2 and all(np.isfinite(m[k]) for k in ("mIoU", "fwIoU", "mACC", "pACC", "hIoU"))
    assert full["mini_val"]["_conf"].shape == (7, 7)


def test_train_resume_then_eval_checkpoint(data, tmp_path, capsys, monkeypatch):
    out = tmp_path / "run"
    # the loop's checkpoint period (5000 steps) cut to 2
    monkeypatch.setattr(train_cli, "train", functools.partial(train_loop.train, checkpoint_every=2))
    args = ["--device", "cpu", "--config", "mini_train", "--dataset", "mini_train", "--data-root", str(data),
            "--output", str(out)]
    state = train_cli.main(args + ["--steps", "2"])
    assert state.step == 2 and (out / "model_0000002.ckpt").exists() and (out / "metrics.json").exists()
    final = torch.load(out / "model_final.pth", weights_only=True)
    assert set(final) == {"model"} and set(final["model"]) == set(state.model.state_dict())
    resumed = train_cli.main(args + ["--steps", "1", "--resume"])
    assert "resumed from" in capsys.readouterr().out and resumed.step == 3
    m = eval_cli.main(["--device", "cpu", "--config", "mini", "--benchmarks", "mini_val", "--data-root", str(data),
                       "--checkpoint", str(out / "model_final.pth"), "--limit", "1"])["mini_val"]
    assert m["num_images"] == 1 and np.isfinite(m["mIoU"])


def test_load_params_routes(tmp_path):
    cfg = mini_cfg_port()
    seeded = common.load_params(None, cfg, seed=3, device="cpu")
    want = init_catseg_(CATSeg(cfg), 3).state_dict()
    assert all(torch.equal(v, want[k]) for k, v in seeded.state_dict().items()) and not seeded.training
    # a catseg_tpu pytree (.npz) through from_jax
    params = mini_params(seed=3)
    wio.save_pytree(str(tmp_path / "p.npz"), params)
    back = wio.load_pytree(str(tmp_path / "p.npz"))
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(back), _leaves(params)))
    from_npz = common.load_params(str(tmp_path / "p.npz"), cfg, device="cpu")
    assert all(torch.allclose(v, want[k]) for k, v in from_npz.state_dict().items())
    # the port's own .pth, bare and as {"model": sd}
    torch.save(want, tmp_path / "bare.pth")
    torch.save({"model": want}, tmp_path / "wrapped.pth")
    for name in ("bare.pth", "wrapped.pth"):
        m = common.load_params(str(tmp_path / name), cfg, device="cpu")
        assert all(torch.equal(v, want[k]) for k, v in m.state_dict().items())
    # a released checkpoint's fused in_proj goes through weights.convert to the same tensors
    from test_torch_convert import fused

    assert set(fused(want)) != set(want)
    torch.save({"model": fused(want)}, tmp_path / "fused.pth")
    m = common.load_params(str(tmp_path / "fused.pth"), cfg, device="cpu")
    assert all(torch.equal(v, want[k]) for k, v in m.state_dict().items())
    with pytest.raises(SystemExit, match="unknown checkpoint format"):
        common.load_params(str(tmp_path / "p.safetensors"), cfg, device="cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def test_presets_and_refusals():
    assert common.resolve_config("vitb384", ["batch_size=2", "compute_dtype=float32"]) == tconfigs.vitb384(
        batch_size=2, compute_dtype="float32")
    assert common.resolve_config("fusion_ver31", []) == tconfigs.fusion_ver31()
    with pytest.raises(SystemExit):
        common.resolve_config("nope", [])


def test_pytree_io_matches_jax(tmp_path):
    from catseg_tpu.weights import io as jio

    tree = {"a": np.arange(6.0).reshape(2, 3), "b": [np.ones(2, np.int32), None, {"c": np.zeros(0)}]}
    jio.save_pytree(str(tmp_path / "j.npz"), tree)
    wio.save_pytree(str(tmp_path / "t.npz"), tree)
    for path in ("j.npz", "t.npz"):
        got = wio.load_pytree(str(tmp_path / path))
        assert got["b"][1] is None and np.array_equal(got["a"], tree["a"]) and got["b"][0].dtype == np.int32
        assert all(np.array_equal(a, b) for a, b in zip(_leaves(got), _leaves(tree), strict=True))
        assert _leaves(jio.load_pytree(str(tmp_path / path)))[0].shape == (2, 3)
