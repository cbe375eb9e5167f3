"""The fusion families' train step in the port against catseg_tpu's, on the CPU, fp32.

The mini Ver31 and Ver14 configs of tests/test_torch_fusion.py (weights
from its ``params()``, carried into the port by ``load_params_``); B = 2
uint8 crops of 96^2, T = 6 COCO train prompts (<= pad_len 8), targets in
[0, 6) with ~10% ignore.  One step of catseg_tpu's ``make_train_step``
(jitted; each family's trace and compile is most of this file's time)
against one step of the port's, for Ver31, Ver14 with raw-corr proposals
and Ver14 with head proposals:

- loss within 1e-5;
- every trainable tensor after the step within 5e-5, and within 1e-6 on
  all but 1% of its elements (tests/test_torch_train.py's bounds and why),
  rounded up to whole elements: a bias of 16 or 32 elements may have one
  (measured: one element of 1.3e-6 and one of 3.0e-6, in 32-element
  biases whose clipped gradients there lie inside Adam's eps);
- every frozen tensor bit-equal;
- the tensors the step moves by more than 1e-6 are the same on both sides.

The batch is seed 2's (:data:`STEP_SEED`).  At seeds 0 and 1 an input of a
ReLU in Ver14's mask-decoder MLP lies within fp32 rounding of zero: the
port's own gradients on one and on four torch threads differ there by 2%
(seed 0) and 5e-4 (seed 1) of a tensor's largest, as catseg_tpu's and the
port's do, and Adam's first step turns such a difference into a flipped
update.  At seed 2 they differ by at most 5e-5 (the attention k biases
aside, whose gradients are zero by symmetry and hold rounding noise).

A trainable parameter the loss does not reach (Ver14 raw-corr's
aggregator) gets no gradient in the port, and torch's AdamW leaves it as
it is; catseg_tpu's AdamW decays it by lr x weight decay (2e-8 of its
value a step), well inside the bounds.
"""

import math

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import jax
import jax.numpy as jnp

from catseg_tpu import configs as jconfigs
from catseg_tpu.core.fusion import fusion_forward as j_fusion_forward
from catseg_tpu.train import loop as jloop
from catseg_tpu.train import optim as joptim

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core.catseg import model_class
from catseg_tpu_torch.core.clip import truncate_context
from catseg_tpu_torch.train import checkpoint, loop, optim
from catseg_tpu_torch.weights.from_jax import load_params_, state_dict_from_params

from test_torch_fusion import close, fusion_cfg, params

T = 6
STEP_SEED = 2
CASES = {"ver31": ("ver31", {}), "ver14_raw_corr": ("ver14", {}), "ver14_head": ("ver14", {"refine_from": "head"})}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread, as tests/test_torch_fusion.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees():
    return {f: params(f) for f in ("ver31", "ver14")}


def _batch(B=2, seed=0, classes=T):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, 96, 96, 3)).astype(np.uint8)
    targets = rng.randint(0, classes, (B, 96, 96)).astype(np.int32)
    targets[rng.rand(B, 96, 96) < 0.1] = 255
    return images, targets


def _tokens(classes=T):
    return loop.class_tokens(tconfigs.class_names("coco")[:classes])


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(trees, case):
    family, kw = CASES[case]
    tree = trees[family]
    images, targets = _batch(seed=STEP_SEED)
    tokens = _tokens()

    jcfg = fusion_cfg(jconfigs, family, **kw)
    jstate, tx = jloop.init_train_state(jax.random.PRNGKey(0), jcfg, params=tree)
    jparams, _, jl = jloop.make_train_step(jcfg, tx, tokens)(jstate.params, jstate.opt_state, images, targets)
    want = state_dict_from_params(jax.device_get(jparams))

    cfg = fusion_cfg(tconfigs, family, **kw)
    state = loop.init_train_state(cfg, params=tree, device="cpu")
    sd0 = {k: v.clone() for k, v in state.model.state_dict().items()}
    loss = loop.make_train_step(cfg, state.optimizer, tokens)(state.model, images, targets)

    check_step(loss.item(), float(jl), state.model.state_dict(), want, sd0, state.optimizer.labels)


def check_step(loss, want_loss, got, want, sd0, labels):
    """A step's loss and tensors after it (``got``) against catseg_tpu's
    (``want``), from the tensors before it (``sd0``), by the module
    docstring's bounds; ``labels`` the optimizer's name -> label."""
    assert abs(loss - want_loss) <= 1e-5, (loss, want_loss)
    assert any(lbl == "frozen" for lbl in labels.values())
    jax_moved, port_moved = set(), set()
    for name, lbl in labels.items():
        if lbl == "frozen":
            assert torch.equal(got[name], sd0[name]), name
            continue
        err = (got[name] - want[name]).abs()
        assert err.max().item() <= 5e-5 and (err > 1e-6).sum().item() <= math.ceil(1e-2 * err.numel()), \
            (name, err.max().item())
        if (want[name] - sd0[name]).abs().max().item() > 1e-6:
            jax_moved.add(name)
        if (got[name] - sd0[name]).abs().max().item() > 1e-6:
            port_moved.add(name)
    assert len(jax_moved) > 100 and port_moved == jax_moved


@pytest.mark.parametrize("family", ["ver31", "ver14"])
def test_fusion_labels_match_jax(trees, family):
    """finetune_labels of the port's model equals catseg_tpu's
    finetune_label_tree for every tensor: each label coded as a constant
    tensor of its leaf's shape and carried through the weight bridge's
    names.  A model without fusion keeps its labels (tests/test_torch_train.py)."""
    tree = trees[family]
    code = {lbl: float(i) for i, lbl in enumerate(optim.LABELS)}
    coded = jax.tree.map(lambda p, lbl: np.full(np.shape(p), code[lbl], np.float32), tree,
                         joptim.finetune_label_tree(tree, "attention"))
    want = state_dict_from_params(coded)
    cfg = fusion_cfg(tconfigs, family)
    got = optim.finetune_labels(model_class(cfg)(cfg), "attention")
    assert set(got) <= set(want)
    for name, lbl in got.items():
        w = want[name].flatten()
        assert (w == w[0]).all() and w[0].item() == code[lbl], (name, lbl, w.unique())
    counts = {lbl: sum(v == lbl for v in got.values()) for lbl in optim.LABELS}
    assert all(counts[k] for k in ("main", "main_nodecay", "clip", "frozen")), counts
    second = "dino_model." if family == "ver31" else "sam_encoder."
    assert all(lbl == "frozen" for n, lbl in got.items() if n.startswith(second))
    if family == "ver31":
        assert got["dino_down_sample.weight"] == got["dino_decod_proj2.weight"] == "main"
    else:
        assert got["sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] == "frozen"
        assert got["sam_decoder.mask_tokens.weight"] == got["sam_decoder.transformer.layers.0.norm3.weight"] \
            == got["sam_prompt_encoder.mask_downscaling.1.weight"] == "main_nodecay"


def test_checkpoint_resume_equals_straight_run(trees, tmp_path):
    """Ver31: train() 3 steps with a checkpoint at step 2; a fresh state
    loaded from it and stepped once equals the straight run."""
    cfg = fusion_cfg(tconfigs, "ver31")
    tokens = _tokens(3)
    batches = [_batch(1, seed, classes=3) for seed in range(3)]

    straight = loop.init_train_state(cfg, params=trees["ver31"], device="cpu")
    loop.train(straight, cfg, iter(batches), tokens, num_steps=3, log_every=1, output_dir=str(tmp_path),
               checkpoint_every=2)
    path = checkpoint.latest_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("model_0000002.ckpt")

    resumed = loop.init_train_state(cfg, params=trees["ver31"], device="cpu")
    resumed.step = checkpoint.load_train_state(path, resumed.model, resumed.optimizer)
    loop.train(resumed, cfg, iter(batches[2:]), tokens, num_steps=1, log_every=0)
    assert resumed.step == straight.step == 3
    a, b = resumed.model.state_dict(), straight.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["dino_down_sample.weight"], state_dict_from_params(trees["ver31"])["dino_down_sample.weight"])


def test_with_coarse_matches_jax(trees):
    """Ver14 head proposals at T = 11 > pad_len 8: forward(with_coarse=True)
    gives catseg_tpu's (coarse (B, T, 32, 32), refined (B, T, 20, 20)),
    both scattered with -100 where top-k dropped a class."""
    T11 = 11
    cfg = fusion_cfg(tconfigs, "ver14", refine_from="head")
    jcfg = fusion_cfg(jconfigs, "ver14", refine_from="head")
    model = load_params_(model_class(cfg)(cfg), trees["ver14"]).eval()
    rng = np.random.RandomState(T11)
    imgs = rng.randint(0, 256, (2, 96, 96, 3)).astype(np.float32)
    text = rng.randn(T11, 1, 64).astype(np.float32)
    want = jax.jit(lambda p, i, t: j_fusion_forward(p, i, t, jcfg, with_coarse=True))(
        trees["ver14"], jnp.asarray(imgs), jnp.asarray(text))
    with torch.inference_mode():
        got = model(torch.from_numpy(imgs), torch.from_numpy(text), with_coarse=True)
        refined_only = model(torch.from_numpy(imgs), torch.from_numpy(text))
    assert got[0].shape == (2, T11, 32, 32) and got[1].shape == (2, T11, 20, 20)
    assert got[0].dtype == got[1].dtype == torch.float32
    for g in got:
        assert ((g == -100.0).all(dim=(2, 3)).sum(1) == T11 - 8).all()
    assert torch.equal(refined_only, got[1])
    for g, w in zip(got, want):
        close(g.numpy(), w)


def test_refinement_recompute_is_bit_equal(trees, monkeypatch):
    """Ver14's refinement steps under torch.utils.checkpoint (the default
    under autograd) give the gradients of the plain steps bit for bit;
    without autograd no step is checkpointed."""
    cfg = fusion_cfg(tconfigs, "ver14")
    images, targets = (torch.from_numpy(a) for a in _batch())
    tokens = torch.from_numpy(truncate_context(_tokens())).long()
    real, steps = torch.utils.checkpoint.checkpoint, []
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", lambda *a, **kw: (steps.append(1), real(*a, **kw))[1])
    grads = {}
    for recompute in (True, False):
        state = loop.init_train_state(cfg, params=trees["ver14"], device="cpu")
        state.model.recompute_refinement = recompute
        loop.train_loss(cfg, state.model, tokens, images, targets).backward()
        grads[recompute] = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
        if recompute:
            assert len(steps) == 3      # 6 classes, 2 a step for each of 2 images (refine_chunk 4)
            with torch.inference_mode():
                state.model(images.float(), torch.zeros(T, 1, 64))
            assert len(steps) == 3
    assert len(steps) == 3
    assert any(n.startswith("sam_decoder.") for n in grads[True])
    assert grads[True].keys() == grads[False].keys()
    assert all(torch.equal(grads[True][n], grads[False][n]) for n in grads[True])


def test_recorded_backward_calls_check_against_plain():
    """selfcheck.recorded_calls(backward=True) records the backward kernels'
    wrappers (chip_smoke [31] holds each call of a train step against its
    plain version so); on the CPU each wrapper is its plain version, so
    check_calls reads 0 for every gradient."""
    from catseg_tpu_torch.kernels import selfcheck

    cases = selfcheck.cases("cpu", torch.float32, small=True)
    with selfcheck.recorded_calls(backward=True) as calls:
        for name in selfcheck.BACKWARD_PAIRS:
            cases[name].kernel()
    assert [name for name, _ in calls] == list(selfcheck.BACKWARD_PAIRS)
    assert selfcheck.check_calls(calls, torch.float32) == {name: (1, 0.0, 0.0) for name in selfcheck.BACKWARD_PAIRS}
    with selfcheck.recorded_calls() as calls:
        cases["swin_block_bwd"].kernel()
    assert calls == []
