"""Rank bodies for tests/test_torch_fusion_class_parallel.py: each runs in a
process of a gloo group that ``catseg_tpu_torch.parallel.mesh.spawn`` starts
on the CPU.  They import torch and the port only (no JAX), pin torch to one
thread, register the mini DINO / SAM variants they are given, and return
numpy results."""

import contextlib
import warnings

import torch

from catseg_tpu_torch.core import aggregator, dino, fusion, sam
from catseg_tpu_torch.core.catseg import model_class
from catseg_tpu_torch.parallel.mesh import make_mesh, rank, shard_batch


def _model(cfg, sd, variants):
    """The port's model of ``cfg`` holding ``sd``; ``variants`` = (DINO
    variant name and value, SAM variant name and value)."""
    torch.set_num_threads(1)
    (dname, dvar), (sname, svar) = variants
    dino.DINO_VARIANTS[dname], sam.SAM_VARIANTS[sname] = dvar, svar
    model = model_class(cfg)(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


def _numpy(out):
    return tuple(_numpy(o) for o in out) if isinstance(out, tuple) else out.numpy()


@contextlib.contextmanager
def _slab_rows(model):
    """Yields a dict that receives, inside the block, what each call of the
    stages in question takes: the Swin stage's and the class stage's class
    count, the rows of Ver31's FusionUP stages (images x classes) and the
    instances of Ver14's mask decoder."""
    rows = {"swin": [], "class": [], "fusion_up": [], "mask_decoder": []}
    patched = [(aggregator, "spatial_aggregation", "swin", 1), (aggregator, "class_aggregation", "class", 1),
               (fusion, "up_tail", "fusion_up", 0)]
    originals = [getattr(mod, attr) for mod, attr, _, _ in patched]
    for (mod, attr, key, axis), fn in zip(patched, originals):
        def record(x, *a, _fn=fn, _key=key, _axis=axis):
            rows[_key].append(x.shape[_axis])
            return _fn(x, *a)
        setattr(mod, attr, record)
    hook = None
    if hasattr(model, "sam_decoder"):
        hook = model.sam_decoder.register_forward_hook(lambda m, args, out: rows["mask_decoder"].append(
            args[0].shape[0]))
    try:
        yield rows
    finally:
        for (mod, attr, _, _), fn in zip(patched, originals):
            setattr(mod, attr, fn)
        if hook is not None:
            hook.remove()


def _forward(model, cfg, mesh, images, text):
    """The model on this rank's images over the class axis of ``mesh``:
    {"full": the gathered output, "local": the slab's, "slab": (t0, t1),
    "classes": kept classes or None, "rows": :func:`_slab_rows`}; Ver14's
    outputs are (coarse, refined) pairs."""
    x = torch.from_numpy(shard_batch(images, mesh.data_index, mesh.shape["data"]))
    t = torch.from_numpy(text)
    kw = {"with_coarse": True} if cfg.fusion.mode == "sam_refine" else {}
    with torch.no_grad():
        full = model(x, t, class_axis=mesh, **kw)
        with _slab_rows(model) as rows:
            local, slab, classes = model(x, t, class_axis=mesh, return_local=True, **kw)
    return {"full": _numpy(full), "local": _numpy(local), "slab": slab,
            "classes": None if classes is None else classes.numpy(), "rows": rows}


def _step(cfg, sd, variants, mesh, images, targets, tokens):
    """One train step on this rank's images: (loss, state dict after)."""
    from catseg_tpu_torch.train.loop import make_train_step
    from catseg_tpu_torch.train.optim import TrainOptimizer

    model = _model(cfg, sd, variants).train()
    step = make_train_step(cfg, TrainOptimizer(cfg, model), tokens, mesh=mesh)
    img, tgt = shard_batch((images, targets), mesh.data_index, mesh.shape["data"])
    loss = float(step(model, img, tgt))
    return loss, {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def two_ranks(models, variants, forward_inputs, step_inputs, indivisible):
    """Mesh {1, 2}: for each case of ``models`` ({case: (cfg, state dict)}) the
    forward on ``forward_inputs`` (images, text) and one train step on
    ``step_inputs`` (images, targets, tokens); then each case again at the
    class count of ``indivisible`` (text, (images, targets, tokens)), which
    does not divide over two ranks: the warnings, the forward and the step."""
    mesh = make_mesh(n_data=1, n_class=2, devices=["cpu"])
    out = {"rank": rank(), "forward": {}, "step": {}, "indivisible": {}}
    text5, step5 = indivisible
    for case, (cfg, sd) in models.items():
        model = _model(cfg, sd, variants).eval()
        out["forward"][case] = _forward(model, cfg, mesh, *forward_inputs)
        out["step"][case] = _step(cfg, sd, variants, mesh, *step_inputs)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fwd = _forward(model, cfg, mesh, forward_inputs[0], text5)
            step = _step(cfg, sd, variants, mesh, *step5)
        out["indivisible"][case] = {"forward": fwd, "step": step, "warnings": [
            str(w.message) for w in seen if issubclass(w.category, UserWarning)]}
    return out


def four_ranks(cfg, sd, variants, step_inputs):
    """Mesh {2, 2}: one train step of ``cfg``, each data row on its half of
    the batch."""
    mesh = make_mesh(n_data=2, n_class=2, devices=["cpu"])
    return {"rank": rank(), "step": _step(cfg, sd, variants, mesh, *step_inputs)}
