"""The port's data parallelism against catseg_tpu's, on the CPU.

Config: catseg_tpu's own mini config (tests/test_catseg_model.py
``mini_cfg``), fp32, with the sliding window of its distributed tests; the
parameters are the port's seeded init, carried to catseg_tpu by its
converter.  The harness case (d) gives the mini CLIP the real vocabulary and
context, which the dataset's class names need.  Ranks: two (or three)
processes that ``parallel.mesh.spawn`` starts in a gloo group over a
FileStore under ``tmp_path``, each on the CPU with one torch thread, running
the rank bodies of tests/torch_parallel_ranks.py (no JAX in them).

- (a) one data-parallel train step over 2 ranks on catseg_tpu's
  ``_train_inputs(B=4)`` against catseg_tpu's ``make_train_step`` on
  ``make_mesh(n_data=4)`` and against the port's one-process step: loss
  within 1e-5, every parameter within 1e-4 (tests/test_shard_map_paths.py's
  bounds); both ranks end bit-equal; then the training loop, where a
  SIGTERM reaching rank 1 stops both ranks at the same step boundary and
  rank 0 alone writes metrics.json and the interrupt checkpoint;
- (b) ``evaluate_sharded`` over 2 ranks on tests/test_distributed_eval.py's
  items (3 images one a dispatch, 9 images two: uneven shares; one spawn) against
  catseg_tpu's on 4 devices with that test's allowance (equal sums, summed
  |d| <= 8 over the class columns) and against the port at world size 1,
  exactly (the same per-rank batches);
- (c) each rank's slice of ``train_batches`` equals its share of the
  one-process batch of the same seed, bit for bit;
- (d) the harness's sharded branch gives the one-process metrics and matrix,
  exactly;
- (e) tile-sharded probabilities over three CPU replicas (ten tiles split
  4 / 3 / 3) against catseg_tpu's ``make_tile_sharded_probs`` on its 8
  virtual devices and the port's unsharded path, within atol 2e-5, rtol
  1e-4 (tests/test_latency_parallel.py's bound); ``Predictor(mesh=)`` takes
  that path;
- (f) the refusals: a class axis outside a process group (one process of
  several devices), a mesh that does not fill its group, a batch that does
  not divide over the ranks (as catseg_tpu's jitted step refuses it), NCCL
  without a GPU, a several-device mesh for training; and a fusion family's
  step on a class mesh builds.  Class axes inside a group:
  tests/test_torch_class_parallel.py, tests/test_torch_fusion_class_parallel.py.
"""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from catseg_tpu.evaluation.distributed import evaluate_sharded as j_evaluate_sharded
from catseg_tpu.parallel.latency import make_tile_sharded_probs as j_make_tile_sharded_probs
from catseg_tpu.parallel.mesh import make_mesh as j_make_mesh
from catseg_tpu.train import loop as jloop
from catseg_tpu.weights.convert import convert_catseg_checkpoint

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
from catseg_tpu_torch.data import catalogs as tcatalogs
from catseg_tpu_torch.data.mapper import train_batches
from catseg_tpu_torch.evaluation.distributed import evaluate_sharded
from catseg_tpu_torch.evaluation.harness import evaluate_benchmark
from catseg_tpu_torch.infer.pipeline import Predictor, sliding_window_probs_from_canvas
from catseg_tpu_torch.parallel import latency, mesh
from catseg_tpu_torch.train import loop as train_loop
from catseg_tpu_torch.train.loop import make_train_step
from catseg_tpu_torch.train.optim import TrainOptimizer
from catseg_tpu_torch.weights.from_jax import state_dict_from_params

import torch_parallel_ranks as ranks
from test_catseg_model import MINI_CLIP, mini_cfg
from test_shard_map_paths import _train_inputs

SLIDING = dict(sliding_window=True, sw_out_res=256, sw_kernel=128, sw_overlap=0.5)
FIXTURES = "tests/torch_fixtures/dataset"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread here, as in each rank (tests/test_torch_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(jcfg, **clip_kw):
    """The port's config with every field of catseg_tpu's ``jcfg`` (and
    ``clip_kw`` replacing fields of its mini CLIP)."""
    names = {f.name for f in dataclasses.fields(tconfigs.CATSegConfig)}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name in names}
    kw["clip"] = tconfigs.CLIPVariant(**{**dataclasses.asdict(MINI_CLIP), **clip_kw})
    return tconfigs.CATSegConfig(**kw)


@pytest.fixture(scope="module")
def params():
    """(catseg_tpu's parameter pytree, the port's state dict) of the port's
    seeded mini init (a JAX random init of the tree takes ~30 s eagerly)."""
    cfg = port_cfg(mini_cfg())
    sd = {k: v.numpy() for k, v in init_catseg_(CATSeg(cfg), 0).state_dict().items()}
    return convert_catseg_checkpoint(sd, num_layers=cfg.num_layers), sd


def _background(fn, *args, **kw):
    """Start fn(*args, **kw) on a thread (the ranks run while this process
    computes the references); returns a function that waits for its result."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(fn, *args, **kw)
    pool.shutdown(wait=False)
    return lambda: future.result(timeout=600)


def _model(cfg, sd):
    model = CATSeg(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


def test_dp_train_step_matches_jax_and_one_process(params, tmp_path):
    p, sd = params
    cfg = mini_cfg(num_classes=6, crop_size=128)
    pcfg = port_cfg(cfg)
    images, targets, tokens = _train_inputs(cfg, B=4)
    out_dir = tmp_path / "train_out"
    ranks_done = _background(mesh.spawn, ranks.train_step, 2, pcfg, sd, images, targets, tokens, str(out_dir),
                             backend="gloo", devices=["cpu", "cpu"], tmp_dir=str(tmp_path))

    _, tx = jloop.init_train_state(jax.random.PRNGKey(0), cfg, params=p)
    jstep = jloop.make_train_step(cfg, tx, tokens, mesh=j_make_mesh(n_data=4, n_class=1))
    jparams = jax.tree.map(jnp.asarray, p)
    jparams, _, jloss = jstep(jparams, tx.init(jparams), jnp.asarray(images), jnp.asarray(targets))
    want_jax = {k: v.numpy() for k, v in state_dict_from_params(jax.tree.map(np.asarray, jparams)).items()}

    model = _model(pcfg, sd).train()
    loss1 = float(make_train_step(pcfg, TrainOptimizer(pcfg, model), tokens)(model, images, targets))
    want_one = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    (loss2, got, refusals, stopped), (loss2_r1, got_r1, _, stopped_r1) = ranks_done()
    assert loss2 == loss2_r1 and all(np.array_equal(got[k], got_r1[k]) for k in got)
    assert abs(loss2 - float(jloss)) < 1e-5, (loss2, float(jloss))
    assert abs(loss2 - loss1) < 1e-5, (loss2, loss1)
    for want in (want_jax, want_one):
        assert want.keys() == got.keys()
        worst = max(float(np.abs(got[k] - want[k]).max()) for k in got)
        assert worst < 1e-4, worst
    assert any(k.endswith("q_proj_weight") and not np.array_equal(got[k], sd[k]) for k in got)
    # (f) in the group: an indivisible global batch, and two devices in one rank
    assert len(refusals) == 2 and "pjit" in refusals[0] and "one device" in refusals[1], refusals
    # a SIGTERM on rank 1 during the loop's 2nd step stops both ranks at the next boundary; rank 0 alone
    # writes: two loss lines and the interrupt line, one checkpoint at step 2
    assert stopped == stopped_r1 == 2, (stopped, stopped_r1)
    lines = [json.loads(line) for line in (out_dir / "metrics.json").read_text().splitlines()]
    assert [rec["iteration"] for rec in lines] == [1, 2, 2] and lines[-1].get("interrupted") == 1.0, lines
    assert sorted(p.name for p in out_dir.iterdir()) == ["last_checkpoint", "log.txt", "metrics.json",
                                                         "model_0000002.ckpt"]


def _eval_items(n_images, T=6):
    """tests/test_distributed_eval.py's items and text."""
    rng = np.random.RandomState(0)
    text = rng.randn(T, 1, 48).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    items = []
    for i in range(n_images):
        h, w = (200 + 4 * i, 260 - 10 * i)
        img = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)
        gt = rng.randint(0, T, (h + 20, w + 20)).astype(np.int32)
        gt[:5] = 255
        items.append((img, gt))
    return items, text


def test_sharded_eval_matches_jax_and_world_1(params, tmp_path):
    p, sd = params
    cfg = mini_cfg(**SLIDING)
    pcfg = port_cfg(cfg)
    cases = [(*_eval_items(n_images), pdb) for n_images, pdb in ((3, 1), (9, 2))]
    ranks_done = _background(mesh.spawn, ranks.evaluate, 2, pcfg, sd, cases, backend="gloo",
                             devices=["cpu", "cpu"], tmp_dir=str(tmp_path))
    wants = []
    for items, text, pdb in cases:
        kw = dict(out_canvas=(256, 512), num_classes=text.shape[0], ignore=255, per_device_batch=pdb)
        wants.append((j_evaluate_sharded(jax.tree.map(jnp.asarray, p), cfg, j_make_mesh(n_data=4, n_class=1),
                                         items, text, input_canvas=(256, 512), **kw),
                      evaluate_sharded(_model(pcfg, sd).eval(), pcfg, mesh.make_mesh(devices=["cpu"]), items,
                                       torch.from_numpy(text), **kw)))
    (got, r0), (got_r1, r1) = ranks_done()
    assert (r0, r1) == (0, 1)
    for (items, text, _), (want_jax, want_one), cm, cm_r1 in zip(cases, wants, got, got_r1):
        T = text.shape[0]
        assert cm.dtype == np.int64 and np.array_equal(cm, cm_r1)
        np.testing.assert_array_equal(cm, want_one)
        assert cm.sum() == len(items) * 256 * 512
        assert cm[:, :T].sum() == want_jax[:, :T].sum()
        assert np.abs(cm[:, :T] - want_jax[:, :T]).sum() <= 8, cm[:, :T] - want_jax[:, :T]


@pytest.mark.parametrize("max_area", [1.0, 0.5])
def test_rank_slices_equal_one_process_batches(max_area):
    from catseg_tpu_torch.data.catalogs import get_dataset
    from catseg_tpu_torch.data.loader import list_dataset

    pairs = list_dataset(get_dataset("ade150"), root=FIXTURES)
    kw = dict(crop_size=256, color_aug=True, ignore=255, single_category_max_area=max_area)
    whole = train_batches(pairs, 4, np.random.default_rng(3), **kw)
    shards = [train_batches(pairs, 4, np.random.default_rng(3), rank=r, world_size=2, **kw) for r in range(2)]
    for _ in range(3):   # three epochs of the 4-image set
        imgs, gts = next(whole)
        for r, shard in enumerate(shards):
            si, sg = next(shard)
            assert si.shape[0] == 2
            np.testing.assert_array_equal(si, imgs[2 * r:2 * r + 2])
            np.testing.assert_array_equal(sg, gts[2 * r:2 * r + 2])


NAMES = ["wall", "building, edifice", "sky", "floor, flooring", "tree", "ceiling"]


@pytest.fixture
def dataset(tmp_path, monkeypatch):
    """Three small images with six-class label maps: tests/test_torch_eval.py's
    "mini_synth" set; the class JSON is found through $CATSEG_CLASS_JSONS,
    which the ranks inherit."""
    rng = np.random.RandomState(0)
    (tmp_path / "imgs").mkdir()
    (tmp_path / "gts").mkdir()
    for i, (h, w) in enumerate([(100, 130), (121, 97), (90, 140)]):
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(tmp_path / "imgs" / f"im{i}.jpg")
        gt = rng.randint(0, len(NAMES), (h, w)).astype(np.uint8)
        gt[:10] = 255
        Image.fromarray(gt).save(tmp_path / "gts" / f"im{i}.png")
    (tmp_path / "mini_classes.json").write_text(json.dumps(NAMES))
    monkeypatch.setenv("CATSEG_CLASS_JSONS", str(tmp_path))
    spec = tcatalogs.DatasetSpec("mini_synth", "imgs", "gts", "mini_classes.json", len(NAMES), 255)
    monkeypatch.setitem(tcatalogs.DATASETS, spec.name, spec)
    return tmp_path, spec


def test_harness_sharded_branch_equals_one_process(dataset, tmp_path):
    root, spec = dataset
    # the mini config with a text tower that reads the real vocabulary
    cfg = port_cfg(mini_cfg(**SLIDING), vocab_size=49408, context=77)
    sd = {k: v.numpy() for k, v in init_catseg_(CATSeg(cfg), 0).state_dict().items()}
    ranks_done = _background(mesh.spawn, ranks.harness, 2, cfg, sd, spec, str(root), backend="gloo",
                             devices=["cpu", "cpu"], tmp_dir=str(tmp_path))
    want = evaluate_benchmark(_model(cfg, sd).eval(), cfg, spec.name, root=str(root), eval_batch=2,
                              verbose=False)
    out = ranks_done()
    for got, conf in out:
        np.testing.assert_array_equal(conf, want["_conf"])
        assert got == {k: want[k] for k in got}
    assert out[0][1].sum() == 3 * 256 * 256


def test_tile_sharded_probs_match_jax_and_unsharded(params):
    p, sd = params
    cfg = mini_cfg(**SLIDING)
    pcfg = port_cfg(cfg)
    rng = np.random.RandomState(0)
    canvas = np.zeros((256, 256, 3), np.uint8)
    canvas[:220, :200] = rng.randint(0, 255, (220, 200, 3), dtype=np.uint8)
    text = rng.randn(7, 1, 48).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    hw = np.asarray([220, 200], np.int32)
    jp = jax.tree.map(jnp.asarray, p)
    assert len(jax.devices()) == 8
    want_jax = np.asarray(j_make_tile_sharded_probs(cfg, j_make_mesh(n_data=8))(
        jp, jnp.asarray(canvas), jnp.asarray(hw), jnp.asarray(text)))

    model = _model(pcfg, sd).eval()
    three = mesh.make_mesh(devices=["cpu"] * 3)
    with torch.inference_mode():
        args = (torch.from_numpy(canvas), torch.from_numpy(hw), torch.from_numpy(text))
        got = latency.make_tile_sharded_probs(pcfg, three)(model, *args).numpy()
        unsharded = sliding_window_probs_from_canvas(model, *args, pcfg).numpy()
    assert got.shape == want_jax.shape == (256, 256, 7)
    np.testing.assert_allclose(got, want_jax, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, unsharded, atol=2e-5, rtol=1e-4)

    image = canvas[:220, :200]
    names = [f"c{i}" for i in range(7)]
    sharded = Predictor(model, pcfg, names, text_feats=text, device="cpu", mesh=three)
    assert sharded._tile_sharded is not None   # the path taken
    base = Predictor(model, pcfg, names, text_feats=text, device="cpu")
    np.testing.assert_allclose(sharded.probs_sliding(image).numpy(), base.probs_sliding(image).numpy(),
                               atol=2e-5, rtol=1e-4)


def test_refusals(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="class axis is a set of ranks"):
        mesh.make_mesh(n_class=2, devices=["cpu"] * 4)
    with pytest.raises(NotImplementedError, match="pjit"):
        mesh.shard_batch(np.zeros((3, 2)), rank=0, world_size=2)
    with pytest.raises(NotImplementedError, match="pjit"):
        next(train_batches([("a", "b")] * 4, 3, np.random.default_rng(0), rank=0, world_size=2))
    with pytest.raises(RuntimeError, match="nccl"):
        mesh.init_process_group("nccl", 0, 1, str(tmp_path / "store"))
    assert not torch.distributed.is_initialized()
    # a fusion family on a class mesh builds its step (the mesh's shape
    # alone, in a world of its two ranks; the groups are needed only to step)
    class_mesh = mesh.Mesh(devices=(torch.device("cpu"),), ranks=2, n_class=2)
    with monkeypatch.context() as m:
        m.setattr(train_loop, "world_size", lambda: 2)
        assert callable(make_train_step(tconfigs.fusion_ver31(), None, np.zeros((2, 77), np.int64), mesh=class_mesh))
    mesh.init_process_group("gloo", 0, 1, str(tmp_path / "gloo_store"))
    try:
        with pytest.raises(ValueError, match="does not fill the group's 1 ranks"):
            mesh.make_mesh(n_data=1, n_class=2, devices=["cpu"])
        assert mesh.make_mesh(n_class=1, devices=["cpu"]).shape == {"data": 1, "class": 1}
    finally:
        mesh.destroy_process_group()
    np.testing.assert_array_equal(mesh.shard_batch(np.arange(6), rank=1, world_size=3), [2, 3])
    one = mesh.make_mesh(devices=["cpu"] * 2, n_data=1)
    assert one.shape == {"data": 1, "class": 1} and one.size == 1
