"""The port's train step, optimizer and checkpoints against catseg_tpu, on the CPU.

Config: the mini config of test_torch_aggregator.py (a mini CLIP, hidden
128, pad_len 8) at the TRAIN preset (pooling 2x2, no eval_preset) with the
fused decoder, fp32; B = 2 crops of 384^2, T = 6 classes (pad terms live).
Parameters: the port's seeded init, converted to a JAX pytree, so both
sides start from the same weights.  One step of each side's
make_train_step from that state:

- loss within 1e-5;
- every trainable tensor after the step within atol 1e-6 on all but 1% of
  its elements (measured worst 0.29%, the corr-embed conv1 weight), and
  within lr / 4 = 5e-5 on those.  Why looser there:
  AdamW's first step moves an element by lr * g / (|g| + 1e-8), and the
  global clip at 0.01 scales this config's gradients down so far that some
  elements' clipped gradients are 1e-10..1e-8, inside Adam's eps, where a
  1e-11 difference in summation noise between the two sides moves the
  update by ~1e-5 (measured worst 2.2e-5, on a decoder conv weight whose
  clipped gradient there is -3e-10); everywhere else the updates agree to
  1e-6;
- every frozen tensor unchanged.
"""

import numpy as np
import pytest
import torch

import jax

from catseg_tpu import configs as jconfigs
from catseg_tpu.train import loop as jloop
from catseg_tpu.train import optim as joptim
from catseg_tpu.weights.convert import convert_catseg_checkpoint

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
from catseg_tpu_torch.train import checkpoint, loop, optim
from catseg_tpu_torch.weights.from_jax import state_dict_from_params

from test_train_step_parity import _reference_groups

T = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's torch work runs on one thread: many small ops would each
    wait on a barrier of the whole thread pool, which stalls whenever the
    suite's parallel workers oversubscribe the cores (the JAX side
    dominates the time on a quiet machine either way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(configs, **kw):
    base = dict(clip=configs.CLIPVariant("mini-B/16", 16, 128, 3, 2, 64, 224, 128, 2, 2),
                guidance_layers=(0, 1), guidance_proj_dim=128, text_guidance_dim=64,
                appearance_guidance_dim=64, pad_len=8, compute_dtype="float32")
    base.update(kw)
    return configs.vitb384(**base)


def _batch(B=2, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, 384, 384, 3)).astype(np.uint8)
    targets = rng.randint(0, T, (B, 384, 384)).astype(np.int32)
    targets[rng.rand(B, 384, 384) < 0.1] = 255
    return images, targets


def _tokens():
    return loop.class_tokens(tconfigs.class_names("coco")[:T])


@pytest.fixture(scope="module")
def start():
    """(JAX parameter pytree, the port's state dict) of the same seeded init."""
    sd = init_catseg_(CATSeg(_cfg(tconfigs)), 0).state_dict()
    return convert_catseg_checkpoint({k: v.numpy() for k, v in sd.items()}, num_layers=2), sd


def test_train_step_matches_jax(start):
    params, sd0 = start
    images, targets = _batch()
    tokens = _tokens()

    jcfg = _cfg(jconfigs)
    jstate, tx = jloop.init_train_state(jax.random.PRNGKey(0), jcfg, params=params)
    jstep = jloop.make_train_step(jcfg, tx, tokens)
    jparams, _, jl = jstep(jstate.params, jstate.opt_state, images, targets)
    want = state_dict_from_params(jax.device_get(jparams))

    cfg = _cfg(tconfigs)
    state = loop.init_train_state(cfg, params=params, device="cpu")
    step = loop.make_train_step(cfg, state.optimizer, tokens)
    loss = step(state.model, images, targets)

    assert abs(loss.item() - float(jl)) <= 1e-5, (loss.item(), float(jl))
    got = state.model.state_dict()
    labels = state.optimizer.labels
    moved = 0
    for name, v in got.items():
        if labels[name] == "frozen":
            assert torch.equal(v, sd0[name]), name
            continue
        err = (v - want[name]).abs()
        assert err.max().item() <= 5e-5 and (err > 1e-6).float().mean().item() <= 1e-2, (name, err.max().item())
        moved += int(not torch.equal(v, sd0[name]))
    assert moved > 0.9 * sum(lbl != "frozen" for lbl in labels.values())


def test_labels_match_reference_groups(start):
    _, sd = start
    groups, frozen = _reference_groups(sd, 2e-4, 0.01, 1e-4)
    want = {k: g for g, kv in groups.items() for k, _ in kv}
    want.update({k: "frozen" for k, _ in frozen})
    model = CATSeg(_cfg(tconfigs))
    assert optim.finetune_labels(model, "attention") == want


def test_zero_grad_step_decays_only_decay_groups(start):
    _, sd = start
    cfg = _cfg(tconfigs)
    model = CATSeg(cfg)
    model.load_state_dict(sd)
    opt = optim.TrainOptimizer(cfg, model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for p in opt.trainable:
        p.grad = torch.zeros_like(p)
    opt.step()
    rate = {"main": cfg.base_lr * cfg.weight_decay, "clip": cfg.base_lr * cfg.clip_multiplier * cfg.weight_decay}
    for n, p in model.named_parameters():
        lbl = opt.labels[n]
        if lbl in rate:
            torch.testing.assert_close(p.detach(), before[n] * (1 - rate[lbl]), rtol=0, atol=1e-9)
        else:
            assert torch.equal(p, before[n]), (n, lbl)


def test_clip_excludes_frozen_grads(start):
    _, sd = start
    cfg = _cfg(tconfigs)
    model = CATSeg(cfg)
    model.load_state_dict(sd)
    opt = optim.TrainOptimizer(cfg, model)
    for p in opt.trainable:
        p.grad = torch.full_like(p, 1e-3)
    frozen = [p for n, p in model.named_parameters() if opt.labels[n] == "frozen"]
    frozen[0].grad = torch.full_like(frozen[0], 1e6)
    want = 1e-3 * sum(p.numel() for p in opt.trainable) ** 0.5
    norm = optim.clip_by_global_norm_(opt.trainable, cfg.grad_clip_norm)
    assert abs(norm.item() - want) <= 1e-4 * want   # fp32 sums of 2.3 M squares
    scale = cfg.grad_clip_norm / want
    assert all(torch.allclose(p.grad, torch.full_like(p, 1e-3 * scale)) for p in opt.trainable)
    assert frozen[0].grad.max().item() == 1e6


@pytest.mark.parametrize("base, max_iter", [(2e-4, 80000), (1e-3, 100)])
def test_cosine_lr_matches_jax(base, max_iter):
    jsched, tsched = joptim.cosine_lr(base, max_iter), optim.cosine_lr(base, max_iter)
    for s in (0, 1, 5, 50, max_iter // 2, max_iter, max_iter + 7):
        assert abs(tsched(s) - float(jsched(s))) <= 1e-7 * base, (base, s)


def test_auto_scale_config_matches_jax():
    for n in (1, 2, 4, 8):
        j = joptim.auto_scale_config(_cfg(jconfigs), n)
        t = optim.auto_scale_config(_cfg(tconfigs), n)
        assert (t.batch_size, t.base_lr, t.max_iter) == (j.batch_size, j.base_lr, j.max_iter)
        assert t.batch_size == 4 * n and t.max_iter == round(80000 / n)


def test_checkpoint_resume_equals_straight_run(start, tmp_path):
    """train() 3 steps with a checkpoint at step 2; a fresh state loaded from
    it and stepped once equals the straight run; metrics.json gets a line per
    logged step."""
    params, _ = start
    cfg = _cfg(tconfigs, pad_len=4)
    tokens = loop.class_tokens(tconfigs.class_names("coco")[:3])
    batches = [_batch(1, seed) for seed in range(3)]
    for b in batches:
        b[1][b[1] != 255] %= 3

    straight = loop.init_train_state(cfg, params=params, device="cpu")
    loop.train(straight, cfg, iter(batches), tokens, num_steps=3, log_every=1, output_dir=str(tmp_path),
               checkpoint_every=2)
    path = checkpoint.latest_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("model_0000002.ckpt")
    assert len((tmp_path / "metrics.json").read_text().splitlines()) == 3

    resumed = loop.init_train_state(cfg, params=params, device="cpu")
    resumed.step = checkpoint.load_train_state(path, resumed.model, resumed.optimizer)
    assert resumed.step == 2
    loop.train(resumed, cfg, iter(batches[2:]), tokens, num_steps=1, log_every=0)
    assert resumed.step == straight.step == 3
    a, b = resumed.model.state_dict(), straight.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_mesh_raises():
    """Training runs one process per device: a mesh of several devices in
    one process raises (data-parallel steps: tests/test_torch_parallel.py)."""
    from catseg_tpu_torch.parallel.mesh import make_mesh

    cfg = _cfg(tconfigs)
    with pytest.raises(NotImplementedError, match="one process per device"):
        loop.make_train_step(cfg, None, _tokens(), mesh=make_mesh(devices=["cpu", "cpu"]))
