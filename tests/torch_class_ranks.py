"""Rank bodies for tests/test_torch_class_parallel.py: each runs in a process
of a gloo group that ``catseg_tpu_torch.parallel.mesh.spawn`` starts on the
CPU.  They import torch and the port only (no JAX), pin torch to one thread,
and return numpy results."""

import warnings

import numpy as np
import torch

from catseg_tpu_torch.core.aggregator import aggregator_forward
from catseg_tpu_torch.core.catseg import CATSeg
from catseg_tpu_torch.parallel.class_axis import gather_classes_axis
from catseg_tpu_torch.parallel.mesh import make_mesh, rank, shard_batch


def _model(cfg, sd):
    torch.set_num_threads(1)
    model = CATSeg(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


def _forward(agg, cfg, mesh, case):
    """The aggregator on this rank's images of ``case`` (img, txt, guid)
    over the class axis of ``mesh``: (logits, kept classes or None)."""
    img, txt, guid = shard_batch(case, mesh.data_index, mesh.shape["data"])
    with torch.no_grad():
        logits, classes = aggregator_forward(agg, torch.from_numpy(img), torch.from_numpy(txt),
                                             tuple(torch.from_numpy(g) for g in guid), cfg, return_classes=True,
                                             class_axis=mesh)
    return logits.numpy(), None if classes is None else classes.numpy()


def _step(cfg, sd, mesh, images, targets, tokens):
    """One train step on this rank's images: (loss, state dict after)."""
    from catseg_tpu_torch.train.loop import make_train_step
    from catseg_tpu_torch.train.optim import TrainOptimizer

    model = _model(cfg, sd).train()
    step = make_train_step(cfg, TrainOptimizer(cfg, model), tokens, mesh=mesh)
    img, tgt = shard_batch((images, targets), mesh.data_index, mesh.shape["data"])
    loss = float(step(model, img, tgt))
    return loss, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _gather_check(mesh):
    """gather_classes_axis of a seeded (2, 3, 4) slab a rank under a loss
    that differs by rank: (the gathered tensor, this rank's gradient)."""
    x = torch.from_numpy(np.random.RandomState(mesh.class_index).randn(2, 3, 4).astype(np.float32))
    x.requires_grad_(True)
    full = gather_classes_axis(x, mesh)
    w = torch.from_numpy(np.random.RandomState(10 + mesh.class_index).randn(*full.shape).astype(np.float32))
    (full * w).sum().backward()
    return full.detach().numpy(), x.grad.numpy()


def two_ranks(cfg, sd, forward_cases, images, targets, tokens, topk_tokens):
    """Mesh {1, 2}: the aggregator on each forward case, one train step at
    T = 6 and one at T > pad_len (top-k), and the gather's check."""
    mesh = make_mesh(n_data=1, n_class=2, devices=["cpu"])
    agg = _model(cfg, sd).agg
    return {"rank": rank(), "forward": [_forward(agg, cfg, mesh, c) for c in forward_cases],
            "step": _step(cfg, sd, mesh, images, targets, tokens),
            "topk_step": _step(cfg, sd, mesh, images, targets, topk_tokens),
            "gather": _gather_check(mesh)}


def four_ranks(cfg, sd, forward_cases, images, targets, tokens, indivisible_case, eval_cfg, items, text):
    """Mesh {2, 2}: the aggregator on each forward case and one train step;
    mesh {1, 4} at T = 6 (no class slab: the warning, then the forward and
    the step); evaluate_sharded over {2, 2}'s four ranks."""
    from catseg_tpu_torch.evaluation.distributed import evaluate_sharded

    square = make_mesh(n_data=2, n_class=2, devices=["cpu"])
    row = make_mesh(n_data=1, n_class=4, devices=["cpu"])
    agg = _model(cfg, sd).agg
    out = {"rank": rank(), "forward": [_forward(agg, cfg, square, c) for c in forward_cases],
           "step": _step(cfg, sd, square, images, targets, tokens)}
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out["indivisible_forward"] = _forward(agg, cfg, row, indivisible_case)
        out["indivisible_step"] = _step(cfg, sd, row, images, targets, tokens)
    out["warnings"] = [str(w.message) for w in seen if issubclass(w.category, UserWarning)]
    model = _model(eval_cfg, sd).eval()
    out["cm"] = evaluate_sharded(model, eval_cfg, square, items, torch.from_numpy(text), out_canvas=(256, 512),
                                 num_classes=text.shape[0], ignore=255, per_device_batch=1)
    return out


def eight_ranks(cfg, sd, forward_cases):
    """Mesh {2, 4}: the aggregator on each forward case."""
    mesh = make_mesh(n_data=2, n_class=4, devices=["cpu"])
    agg = _model(cfg, sd).agg
    return {"rank": rank(), "forward": [_forward(agg, cfg, mesh, c) for c in forward_cases]}
