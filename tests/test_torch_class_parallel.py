"""The port's class-axis model parallelism against catseg_tpu's unmeshed
functions and the port's one process, on the CPU.

Config: catseg_tpu's own mini config (tests/test_catseg_model.py
``mini_cfg``: hidden 32, an 8x8 grid, pad_len 12), fp32; the parameters are
the port's seeded init with its padding token and guidance drawn at random
(so the class layer's pad terms carry weight), carried to catseg_tpu by its
converter.  Ranks: processes that ``parallel.mesh.spawn`` starts in gloo
groups of 2, 4 and 8 over FileStores under ``tmp_path``, each on the CPU
with one torch thread, running the rank bodies of
tests/torch_class_ranks.py (no JAX in them) while this process computes the
references.

- the aggregator forward on meshes {1, 2}, {2, 2} and {2, 4}, global batch
  2, at T = 8 (no top-k) and T = 20 (top-k to the 12 best classes): the
  logits within atol 2e-5, rtol 1e-4 of catseg_tpu's unmeshed
  ``aggregator_forward`` and of the port's one process, the kept sets
  equal, and the first class of every class shard asserted on its own (on
  {2, 4} it is where catseg_tpu's own GSPMD run diverges, ROADMAP C3);
- one train step at ``mini_cfg(num_classes=6)``, B = 4, on {1, 2} and
  {2, 2} against catseg_tpu's unmeshed ``make_train_step`` and the port's
  one process: loss within 1e-5, every parameter within 1e-4
  (tests/test_shard_map_paths.py's bounds), the ranks bit-equal; on {1, 2}
  also a step at T = 16 > pad_len against the port's one process;
- T = 6 on {1, 4}, which does not divide: the warning, then the forward
  and the step equal to one process (the class ranks' mean, not sum);
- ``gather_classes_axis``: forward equal to ``torch.cat`` of the slabs,
  backward equal to the unsharded gradient;
- ``evaluate_sharded`` over a {2, 2} mesh: images over all four ranks, the
  matrix equal to one process's.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catseg_tpu.core.aggregator import aggregator_forward as j_aggregator_forward
from catseg_tpu.train import loop as jloop
from catseg_tpu.weights.convert import convert_catseg_checkpoint

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core.aggregator import aggregator_forward
from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
from catseg_tpu_torch.evaluation.distributed import evaluate_sharded
from catseg_tpu_torch.parallel import mesh
from catseg_tpu_torch.train.loop import make_train_step
from catseg_tpu_torch.train.optim import TrainOptimizer

import torch_class_ranks as ranks
from test_catseg_model import MINI_CLIP, mini_cfg
from test_shard_map_paths import _train_inputs

ATOL, RTOL = 2e-5, 1e-4
FORWARD_T = (8, 20)          # at and past pad_len 12
SLIDING = dict(sliding_window=True, sw_out_res=256, sw_kernel=128, sw_overlap=0.5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread here, as in each rank (tests/test_torch_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(jcfg):
    """The port's config with every field of catseg_tpu's ``jcfg``."""
    names = {f.name for f in dataclasses.fields(tconfigs.CATSegConfig)}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name in names}
    kw["clip"] = tconfigs.CLIPVariant(**dataclasses.asdict(MINI_CLIP))
    return tconfigs.CATSegConfig(**kw)


def _background(fn, *args, **kw):
    """Start fn(*args, **kw) on a thread; returns a function that waits for
    its result."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(fn, *args, **kw)
    pool.shutdown(wait=False)
    return lambda: future.result(timeout=600)


def _model(cfg, sd):
    model = CATSeg(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


def _forward_cases():
    """(img (2, 8, 8, 48), text (2, T, 1, 48), guidance) at each FORWARD_T."""
    rng = np.random.RandomState(3)
    cases = []
    for T in FORWARD_T:
        img = rng.randn(2, 8, 8, 48).astype(np.float32)
        txt = rng.randn(2, T, 1, 48).astype(np.float32)
        guid = tuple(rng.randn(2, s, s, c).astype(np.float32) for s, c in ((8, 48), (16, 256), (32, 128)))
        cases.append((img, txt, guid))
    return cases


def _tokens(T):
    """tests/test_shard_map_paths.py's token pattern for T classes."""
    tokens = np.zeros((T, MINI_CLIP.context), np.int32)
    tokens[:, 0] = 1
    tokens[:, 1] = np.arange(T) + 10
    tokens[:, 2] = 2
    return tokens


def _eval_items(n_images=5, T=6):
    rng = np.random.RandomState(1)
    text = rng.randn(T, 1, 48).astype(np.float32)
    text /= np.linalg.norm(text, axis=-1, keepdims=True)
    items = []
    for i in range(n_images):
        h, w = 200 + 4 * i, 260 - 10 * i
        gt = rng.randint(0, T, (h + 20, w + 20)).astype(np.int32)
        gt[:5] = 255
        items.append((rng.randint(0, 255, (h, w, 3), dtype=np.uint8), gt))
    return items, text


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Starts the three groups of ranks, then computes the references while
    they run: {"params", "sd", "cases", "train", "ranks": {n: waiter}}."""
    jcfg = mini_cfg(num_classes=6, crop_size=128)
    cfg = port_cfg(jcfg)
    model = init_catseg_(CATSeg(cfg), 0)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("padding_tokens", "padding_guidance")):
                p.copy_(torch.randn(p.shape, generator=gen))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = convert_catseg_checkpoint(sd, num_layers=cfg.num_layers)
    cases = _forward_cases()
    images, targets, tokens = _train_inputs(jcfg, B=4)
    indivisible = _forward_cases()[0]
    indivisible = (indivisible[0], indivisible[1][:, :6], indivisible[2])
    eval_cfg = port_cfg(mini_cfg(**SLIDING))
    items, text = _eval_items()
    tmp = tmp_path_factory.mktemp("class_ranks")
    cpu = dict(backend="gloo", tmp_dir=str(tmp))
    waiters = {
        8: _background(mesh.spawn, ranks.eight_ranks, 8, cfg, sd, cases, devices=["cpu"] * 8, **cpu),
        4: _background(mesh.spawn, ranks.four_ranks, 4, cfg, sd, cases, images, targets, tokens, indivisible,
                       eval_cfg, items, text, devices=["cpu"] * 4, **cpu),
        2: _background(mesh.spawn, ranks.two_ranks, 2, cfg, sd, cases, images, targets, tokens, _tokens(16),
                       devices=["cpu"] * 2, **cpu),
    }
    return {"cfg": cfg, "jcfg": jcfg, "params": params, "sd": sd, "cases": cases, "indivisible": indivisible,
            "train": (images, targets, tokens), "eval": (eval_cfg, items, text), "ranks": waiters}


def _one_process_forward(setup, case):
    agg = _model(setup["cfg"], setup["sd"]).agg
    img, txt, guid = case
    with torch.no_grad():
        logits, classes = aggregator_forward(agg, torch.from_numpy(img), torch.from_numpy(txt),
                                             tuple(torch.from_numpy(g) for g in guid), setup["cfg"],
                                             return_classes=True)
    return logits.numpy(), None if classes is None else classes.numpy()


@pytest.fixture(scope="module")
def forward_refs(setup):
    """Per forward case: catseg_tpu's unmeshed logits and kept classes, and
    the port's one process's."""
    refs = []
    # jitted: eager dispatch of the mini forward took ~3x as long here
    forward = jax.jit(functools.partial(j_aggregator_forward, cfg=setup["jcfg"], return_classes=True))
    for img, txt, guid in setup["cases"]:
        jl, jc = forward(setup["params"]["agg"], jnp.asarray(img), jnp.asarray(txt),
                         tuple(jnp.asarray(g) for g in guid))
        refs.append(((np.asarray(jl), None if jc is None else np.asarray(jc)),
                     _one_process_forward(setup, (img, txt, guid))))
    return refs


def _by_class(logits, classes, T):
    """(B, T_kept, H, W) kept-class logits -> {class id: (H, W)} per image."""
    if classes is None:
        return [{t: logits[b, t] for t in range(T)} for b in range(logits.shape[0])]
    return [{int(c): logits[b, i] for i, c in enumerate(classes[b])} for b in range(logits.shape[0])]


@pytest.mark.parametrize("n_data,n_class", [(1, 2), (2, 2), (2, 4)])
def test_forward_matches_jax_and_one_process(setup, forward_refs, n_data, n_class):
    out = setup["ranks"][n_data * n_class]()
    for i, ((want_j, want_one), case) in enumerate(zip(forward_refs, setup["cases"])):
        T = case[1].shape[1]
        kept = min(T, setup["cfg"].pad_len)
        # every class rank of a data row returns the gathered logits; rows stack the batch
        rows = []
        for d in range(n_data):
            row = [out[d * n_class + c]["forward"][i] for c in range(n_class)]
            for logits, classes in row[1:]:
                np.testing.assert_array_equal(logits, row[0][0])
                assert (classes is None) == (row[0][1] is None)
            rows.append(row[0])
        got = np.concatenate([r[0] for r in rows])
        got_cls = None if rows[0][1] is None else np.concatenate([r[1] for r in rows])
        assert got.shape == (2, kept, 32, 32)
        for want, want_cls in (want_j, want_one):
            assert (got_cls is None) == (want_cls is None)
            g, w = _by_class(got, got_cls, T), _by_class(want, want_cls, T)
            for b in range(2):
                assert g[b].keys() == w[b].keys()              # equal kept sets
                for t in g[b]:
                    np.testing.assert_allclose(g[b][t], w[b][t], atol=ATOL, rtol=RTOL)
                # the first class of every class shard, on its own
                k = kept // n_class
                for c in range(n_class):
                    first = c * k if got_cls is None else int(got_cls[b, c * k])
                    np.testing.assert_allclose(g[b][first], w[b][first], atol=ATOL, rtol=RTOL,
                                               err_msg=f"first class of shard {c}, image {b}, T={T}")


@pytest.fixture(scope="module")
def step_refs(setup):
    """catseg_tpu's unmeshed step and the port's one process on the B = 4
    batch at T = 6 (and the port's at T = 16): (loss, parameters)."""
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    images, targets, tokens = setup["train"]
    from catseg_tpu_torch.weights.from_jax import state_dict_from_params

    _, tx = jloop.init_train_state(jax.random.PRNGKey(0), jcfg, params=setup["params"])
    jstep = jloop.make_train_step(jcfg, tx, tokens)
    jparams = jax.tree.map(jnp.asarray, setup["params"])
    jparams, _, jloss = jstep(jparams, tx.init(jparams), jnp.asarray(images), jnp.asarray(targets))
    want_jax = {k: v.numpy() for k, v in state_dict_from_params(jax.tree.map(np.asarray, jparams)).items()}

    def one(toks):
        model = _model(cfg, setup["sd"]).train()
        loss = float(make_train_step(cfg, TrainOptimizer(cfg, model), toks)(model, images, targets))
        return loss, {k: v.detach().numpy() for k, v in model.state_dict().items()}

    return {"jax": (float(jloss), want_jax), "one": one(tokens), "topk_one": one(_tokens(16))}


def _check_step(got_ranks, wants, sd):
    (loss, got), rest = got_ranks[0], got_ranks[1:]
    for loss_r, got_r in rest:          # the ranks end bit-equal
        assert loss_r == loss and all(np.array_equal(got[k], got_r[k]) for k in got)
    for want_loss, want in wants:
        assert abs(loss - want_loss) < 1e-5, (loss, want_loss)
        assert want.keys() == got.keys()
        worst = max(float(np.abs(got[k] - want[k]).max()) for k in got)
        assert worst < 1e-4, worst
    assert any(k.endswith("q_proj_weight") and not np.array_equal(got[k], sd[k]) for k in got)


@pytest.mark.parametrize("n_data,n_class", [(1, 2), (2, 2)])
def test_train_step_matches_jax_and_one_process(setup, step_refs, n_data, n_class):
    out = setup["ranks"][n_data * n_class]()
    _check_step([r["step"] for r in out], [step_refs["jax"], step_refs["one"]], setup["sd"])
    if n_data == 1:                     # T = 16 > pad_len: the loss on each rank's kept slab
        _check_step([r["topk_step"] for r in out], [step_refs["topk_one"]], setup["sd"])


def test_indivisible_classes_warn_and_match_one_process(setup, step_refs):
    out = setup["ranks"][4]()
    for r in out:
        assert any("T=6 not divisible by mesh class axis 4" in w for w in r["warnings"]), r["warnings"]
    want, _ = _one_process_forward(setup, setup["indivisible"])
    for r in out:
        logits, classes = r["indivisible_forward"]
        assert classes is None
        np.testing.assert_allclose(logits, want, atol=ATOL, rtol=RTOL)
    _check_step([r["indivisible_step"] for r in out], [step_refs["one"]], setup["sd"])


def test_gather_classes_axis_forward_and_backward(setup):
    out = setup["ranks"][2]()
    slabs = [torch.from_numpy(np.random.RandomState(c).randn(2, 3, 4).astype(np.float32)).requires_grad_(True)
             for c in range(2)]
    full = torch.cat(slabs, dim=1)
    ws = [torch.from_numpy(np.random.RandomState(10 + c).randn(2, 6, 4).astype(np.float32)) for c in range(2)]
    sum((full * w).sum() for w in ws).backward()
    for c, r in enumerate(out):
        got_full, got_grad = r["gather"]
        np.testing.assert_array_equal(got_full, full.detach().numpy())
        np.testing.assert_allclose(got_grad, slabs[c].grad.numpy(), rtol=1e-6, atol=1e-6)


def test_evaluate_sharded_over_a_class_mesh(setup):
    eval_cfg, items, text = setup["eval"]
    want = evaluate_sharded(_model(eval_cfg, setup["sd"]).eval(), eval_cfg, mesh.make_mesh(devices=["cpu"]), items,
                            torch.from_numpy(text), out_canvas=(256, 512), num_classes=text.shape[0], ignore=255,
                            per_device_batch=1)
    out = setup["ranks"][4]()
    for r in out:
        assert r["cm"].dtype == np.int64
        np.testing.assert_array_equal(r["cm"], want)
    assert want.sum() == len(items) * 256 * 512
