"""Rank bodies for tests/test_torch_parallel.py: each runs in a process of a
gloo group that ``catseg_tpu_torch.parallel.mesh.spawn`` starts on the CPU.
They import torch and the port only (no JAX), pin torch to one thread, and
return numpy results."""

import os
import signal

import torch

from catseg_tpu_torch.core.catseg import CATSeg
from catseg_tpu_torch.parallel.mesh import make_mesh, rank, shard_batch, world_size


def _model(cfg, sd):
    torch.set_num_threads(1)
    model = CATSeg(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


def _batches(batch, signal_at: int | None):
    """This rank's slice of ``batch`` forever; before the ``signal_at``-th
    one the process sends itself SIGTERM."""
    n = 0
    while True:
        n += 1
        if n == signal_at:
            os.kill(os.getpid(), signal.SIGTERM)
        yield shard_batch(batch)


def train_step(cfg, sd, images, targets, tokens, output_dir):
    """One data-parallel step on this rank's slice of the global batch, then
    ``train`` for up to 4 more steps with a SIGTERM reaching rank 1 while it
    fetches its 2nd batch: (loss, state dict after the first step, the
    refusals seen, the step at which ``train`` stopped)."""
    from catseg_tpu_torch.train.loop import TrainState, make_train_step, train
    from catseg_tpu_torch.train.optim import TrainOptimizer

    model = _model(cfg, sd).train()
    opt = TrainOptimizer(cfg, model)
    refusals = []
    try:
        make_train_step(cfg.replace(batch_size=world_size() + 1), opt, tokens)
    except NotImplementedError as e:
        refusals.append(str(e))
    try:
        make_mesh(devices=["cpu", "cpu"])
    except ValueError as e:
        refusals.append(str(e))
    step = make_train_step(cfg, opt, tokens, mesh=make_mesh(devices=["cpu"]))
    img, tgt = shard_batch((images, targets))
    loss = step(model, img, tgt)
    after = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    state = TrainState(model=model, optimizer=opt)
    try:
        train(state, cfg, _batches((images, targets), 2 if rank() == 1 else None), tokens, num_steps=4,
              log_every=1, output_dir=output_dir)
        stopped = None
    except KeyboardInterrupt:
        stopped = state.step
    return float(loss), after, refusals, stopped


def evaluate(cfg, sd, cases):
    """evaluate_sharded on this rank's share of each (items, text,
    per_device_batch) case: ([matrix per case], rank)."""
    from catseg_tpu_torch.evaluation.distributed import evaluate_sharded

    model = _model(cfg, sd).eval()
    cms = [evaluate_sharded(model, cfg, make_mesh(devices=["cpu"]), items, torch.from_numpy(text),
                            out_canvas=(256, 512), num_classes=text.shape[0], ignore=255, per_device_batch=pdb)
           for items, text, pdb in cases]
    return cms, rank()


def harness(cfg, sd, spec, root):
    """evaluate_benchmark over the ranks on dataset ``spec`` (registered
    here): the metrics without the per-class arrays, and the matrix."""
    from catseg_tpu_torch.data import catalogs
    from catseg_tpu_torch.evaluation.harness import evaluate_benchmark

    catalogs.DATASETS[spec.name] = spec
    model = _model(cfg, sd).eval()
    m = evaluate_benchmark(model, cfg, spec.name, root=root, eval_batch=2)
    return {k: m[k] for k in ("mIoU", "fwIoU", "mACC", "pACC", "num_images")}, m["_conf"]
