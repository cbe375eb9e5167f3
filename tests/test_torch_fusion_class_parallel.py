"""The fusion families on the port's class axis against catseg_tpu's
unmeshed functions and the port's one process, on the CPU, fp32.

Configs and weights: tests/test_torch_fusion.py's mini Ver31, Ver14 with
raw-corr proposals and Ver14 with head proposals (``fusion_cfg``,
``params``; pad_len 8).  Ranks: processes that ``parallel.mesh.spawn``
starts in gloo groups of 2 and 4 over FileStores under ``tmp_path``, one
spawn a group size, each on the CPU with one torch thread, running the rank
bodies of tests/torch_fusion_class_ranks.py (no JAX in them) while this
process computes the references (catseg_tpu's jitted programs traced here
one after another and compiled on a thread pool).

- the forward on the mesh {1, 2} at T = 12 (top-k to 8, 4 a rank), global
  batch 2: the gathered logits (Ver14: coarse and refined) within atol
  2e-5, rtol 1e-4 of catseg_tpu's unmeshed, jitted ``fusion_forward``, the
  kept sets equal, and the first class of each rank's slab asserted on its
  own from that rank's slab output;
- what ran on the slab: each Swin pair on 4 classes and each class layer
  on the 8 gathered ones, both FusionUP stages over 2 x 4 rows and the
  mask decoder over 8 instances (4 classes of 2 images, 2 a step), not 16;
- one train step on {1, 2} at T = 12 against catseg_tpu's unmeshed
  ``make_train_step`` with tests/test_torch_fusion_train.py's bounds (loss
  within 1e-5; trainable tensors within 5e-5, within 1e-6 on all but 1%;
  frozen ones bit-equal), the ranks bit-equal;
- Ver31's step on {2, 2} (one image a data row) against the same and the
  port's one process;
- T = 5 on {1, 2}, which does not divide: the warning, then the forward and
  the step equal to the port's one process.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catseg_tpu import configs as jconfigs
from catseg_tpu.core.fusion import fusion_forward as j_fusion_forward
from catseg_tpu.train import loop as jloop

from catseg_tpu_torch import configs as tconfigs
from catseg_tpu_torch.core import dino as tdino
from catseg_tpu_torch.core import sam as tsam
from catseg_tpu_torch.core.catseg import model_class
from catseg_tpu_torch.parallel import mesh
from catseg_tpu_torch.train import loop
from catseg_tpu_torch.train.optim import TrainOptimizer
from catseg_tpu_torch.weights.from_jax import state_dict_from_params

import torch_fusion_class_ranks as ranks
from test_torch_fusion import close, fusion_cfg, params
from test_torch_fusion_train import STEP_SEED, _batch, _tokens, check_step

ATOL, RTOL = 2e-5, 1e-4
T = 12                 # top-k to pad_len 8: 4 kept classes a rank on {1, 2}
T_INDIVISIBLE = 5      # no top-k, and 5 does not divide over 2 ranks
CASES = {"ver31": ("ver31", {}), "ver14_raw_corr": ("ver14", {}), "ver14_head": ("ver14", {"refine_from": "head"})}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread here, as in each rank."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _background(fn, *args, **kw):
    """Start fn(*args, **kw) on a thread; returns a function that waits for
    its result."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(fn, *args, **kw)
    pool.shutdown(wait=False)
    return lambda: future.result(timeout=600)


def _forward_inputs(T_):
    rng = np.random.RandomState(T_)
    return rng.randint(0, 256, (2, 96, 96, 3)).astype(np.float32), rng.randn(T_, 1, 64).astype(np.float32)


def _jax_references(trees, step_inputs, forward_inputs):
    """{case: waiter of (forward output, (loss, state dict))} of catseg_tpu's
    unmeshed jitted forward and train step: each program traced here (the
    tracing holds the interpreter), compiled and run on a pool thread."""
    pool = ThreadPoolExecutor(len(CASES) * 2)

    def run(lowered, args):
        return jax.device_get(lowered.compile()(*args))

    images, targets, tokens = step_inputs
    imgs, text = (jnp.asarray(a) for a in forward_inputs)
    steps, forwards = {}, {}
    for case, (family, kw) in CASES.items():
        jcfg = fusion_cfg(jconfigs, family, **kw)
        state, tx = jloop.init_train_state(jax.random.PRNGKey(0), jcfg, params=trees[family])
        args = (state.params, state.opt_state, images, targets)
        steps[case] = pool.submit(run, jloop.make_train_step(jcfg, tx, tokens).lower(*args), args)
    for case, (family, kw) in CASES.items():
        jcfg = fusion_cfg(jconfigs, family, **kw)

        def forward(p, i, t, jcfg=jcfg):
            return j_fusion_forward(p, i, t, jcfg, with_coarse=jcfg.fusion.mode == "sam_refine")

        args = (trees[family], imgs, text)
        forwards[case] = pool.submit(run, jax.jit(forward).lower(*args), args)
    pool.shutdown(wait=False)

    def waiter(case):
        def wait():
            params_, _, loss = steps[case].result(timeout=600)
            sd = {k: v for k, v in state_dict_from_params(params_).items()}
            return forwards[case].result(timeout=600), (float(loss), sd)
        return wait

    return {case: waiter(case) for case in CASES}


def _port_model(case, sd):
    family, kw = CASES[case]
    cfg = fusion_cfg(tconfigs, family, **kw)
    model = model_class(cfg)(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model, cfg


def _one_process_step(case, sd, images, targets, tokens):
    model, cfg = _port_model(case, sd)
    model.train()
    loss = loop.make_train_step(cfg, TrainOptimizer(cfg, model), tokens)(model, images, targets)
    return loss.item(), {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Starts both groups of ranks, then computes the references while they
    run: {"sd", "labels", "jax", "one", "ranks": {n: waiter}}."""
    trees = {f: params(f) for f in ("ver31", "ver14")}
    sds = {f: {k: v.numpy() for k, v in state_dict_from_params(t).items()} for f, t in trees.items()}
    models = {case: (fusion_cfg(tconfigs, family, **kw), sds[family]) for case, (family, kw) in CASES.items()}
    variants = (("torch_mini_dino", tdino.DINO_VARIANTS["torch_mini_dino"]),
                ("torch_mini_sam", tsam.SAM_VARIANTS["torch_mini_sam"]))
    images, targets = _batch(seed=STEP_SEED, classes=T)
    tokens = _tokens(T)
    forward_inputs = _forward_inputs(T)
    text5 = _forward_inputs(T_INDIVISIBLE)[1]
    step5 = (*_batch(seed=STEP_SEED, classes=T_INDIVISIBLE), _tokens(T_INDIVISIBLE))
    tmp = tmp_path_factory.mktemp("fusion_class_ranks")
    cpu = dict(backend="gloo", tmp_dir=str(tmp))
    waiters = {
        2: _background(mesh.spawn, ranks.two_ranks, 2, models, variants, forward_inputs, (images, targets, tokens),
                       (text5, step5), devices=["cpu"] * 2, **cpu),
        4: _background(mesh.spawn, ranks.four_ranks, 4, *models["ver31"], variants, (images, targets, tokens),
                       devices=["cpu"] * 4, **cpu),
    }
    jax_refs = _jax_references(trees, (images, targets, tokens), forward_inputs)

    one = {"ver31_step": _one_process_step("ver31", models["ver31"][1], images, targets, tokens)}
    for case in CASES:
        model, cfg = _port_model(case, models[case][1])
        kw = {"with_coarse": True} if cfg.fusion.mode == "sam_refine" else {}
        with torch.no_grad():
            one[case] = [_numpy(model.eval()(torch.from_numpy(forward_inputs[0]), torch.from_numpy(t), **kw))
                         for t in (forward_inputs[1], text5)]
        one[case].append(_one_process_step(case, models[case][1], *step5))
    labels = {case: TrainOptimizer(models[case][0], _port_model(case, models[case][1])[0]).labels for case in CASES}
    return {"sd": {case: {k: torch.from_numpy(v) for k, v in sd.items()} for case, (_, sd) in models.items()},
            "labels": labels, "jax": jax_refs, "one": one, "ranks": waiters}


def _numpy(out):
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


def _outputs(out):
    """Ver14's (coarse, refined) or the one output of Ver31, as a tuple."""
    return out if isinstance(out, tuple) else (out,)


def _kept_sets(logits):
    """Per image, the classes whose logit planes are not all -100."""
    return [set(np.flatnonzero(~(np.asarray(lg) == -100.0).all(axis=(1, 2))).tolist()) for lg in logits]


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(setup, case):
    """Ver14's refined masks are held to catseg_tpu by the README's oracle
    bound, as tests/test_torch_fusion.py holds the port's one process
    (whose refined logits, up to ~9, already differ from catseg_tpu's by up
    to 9e-5 here), and to the port's one process within atol 2e-5, rtol
    1e-4; every other output to both within the latter."""
    out = setup["ranks"][2]()
    want, _ = setup["jax"][case]()
    one = setup["one"][case][0]
    for r in out:
        got = r["forward"][case]
        classes, (t0, t1) = got["classes"], got["slab"]
        assert (t0, t1) == (4 * r["rank"], 4 * r["rank"] + 4)
        for i, (g, w, o, loc) in enumerate(zip(*map(_outputs, (got["full"], want, one, got["local"])))):
            w = np.asarray(w)
            assert g.shape == w.shape and g.shape[1] == T and loc.shape[1] == 4
            refined = CASES[case][0] == "ver14" and i == 1
            np.testing.assert_allclose(g, o, atol=ATOL, rtol=RTOL)
            if refined:
                close(g, w)
            else:
                np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
            kept = _kept_sets(w)
            assert _kept_sets(g) == kept and [set(c.tolist()) for c in classes] == kept
            # the first class of this rank's slab, from its own slab output
            for b in range(2):
                first = classes[b, t0]
                np.testing.assert_allclose(loc[b, 0], o[b, first], atol=ATOL, rtol=RTOL,
                                           err_msg=f"first class of rank {r['rank']}'s slab, image {b}")
                if refined:
                    close(loc[b, 0], w[b, first])
                else:
                    np.testing.assert_allclose(loc[b, 0], w[b, first], atol=ATOL, rtol=RTOL,
                                               err_msg=f"first class of rank {r['rank']}'s slab, image {b}")


@pytest.mark.parametrize("case", list(CASES))
def test_slab_stages_run_on_the_slab_only(setup, case):
    """Each rank's Swin pairs, FusionUP stages and SAM refinement take its 4
    kept classes of 2 images; each class layer takes all 8."""
    family, kw = CASES[case]
    for r in setup["ranks"][2]():
        rows = r["forward"][case]["rows"]
        swin = family == "ver31" or kw.get("refine_from") == "head"
        assert rows["swin"] == ([4] * 2 if swin else [])          # 2 layers
        assert rows["class"] == ([8] * 2 if swin else [])
        assert rows["fusion_up"] == ([2 * 4] * 2 if family == "ver31" else [])
        # refine_chunk 4 over 2 images: 2 classes an image a step, 2 steps
        assert rows["mask_decoder"] == ([2 * 2] * 2 if family == "ver14" else [])


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(setup, case):
    out = setup["ranks"][2]()
    _, (want_loss, want) = setup["jax"][case]()
    (loss, got), rest = out[0]["step"][case], [r["step"][case] for r in out[1:]]
    for loss_r, got_r in rest:          # the ranks end bit-equal
        assert loss_r == loss and all(np.array_equal(got[k], got_r[k]) for k in got)
    check_step(loss, want_loss, {k: torch.from_numpy(v) for k, v in got.items()}, want, setup["sd"][case],
               setup["labels"][case])


def test_ver31_step_on_two_data_rows(setup):
    """Mesh {2, 2}: each data row's two class ranks on one image; against
    catseg_tpu's unmeshed step and the port's one process."""
    out = setup["ranks"][4]()
    _, (want_loss, want) = setup["jax"]["ver31"]()
    one_loss, one = setup["one"]["ver31_step"]
    (loss, got), rest = out[0]["step"], [r["step"] for r in out[1:]]
    for loss_r, got_r in rest:
        assert loss_r == loss and all(np.array_equal(got[k], got_r[k]) for k in got)
    got = {k: torch.from_numpy(v) for k, v in got.items()}
    for ref_loss, ref in ((want_loss, want), (one_loss, one)):
        check_step(loss, ref_loss, got, ref, setup["sd"]["ver31"], setup["labels"]["ver31"])


@pytest.mark.parametrize("case", list(CASES))
def test_indivisible_classes_warn_and_match_one_process(setup, case):
    """T = 5 over two class ranks: each warns and computes all 5 classes;
    the forward and the step (the class ranks' mean) equal one process's."""
    _, want_out, (want_loss, want) = setup["one"][case]
    for r in setup["ranks"][2]():
        got = r["indivisible"][case]
        assert any(f"T={T_INDIVISIBLE} not divisible by mesh class axis 2" in w for w in got["warnings"]), \
            got["warnings"]
        assert got["forward"]["slab"] == (0, T_INDIVISIBLE)
        for g, w in zip(_outputs(got["forward"]["full"]), _outputs(want_out)):
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
        loss, params_ = got["step"]
        assert abs(loss - want_loss) <= 1e-5, (loss, want_loss)
        worst = max(float(np.abs(params_[k] - want[k].numpy()).max()) for k in want)
        assert worst <= 1e-6, worst
