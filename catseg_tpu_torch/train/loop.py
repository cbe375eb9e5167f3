"""Training step and loop on one device (catseg_tpu/train/loop.py).

The class text is re-encoded in every step (the text encoder is being
finetuned, cat_seg_predictor.py:209-210), so gradients flow through both
CLIP towers into their q/v projection weights.  Frozen parameters carry
``requires_grad=False`` (the JAX step's stop_gradient), so their weight
gradients are never formed and the clip never sees them.

The fusion families train as catseg_tpu's step does: Ver31 with one BCE
on its logits (DINO frozen), Ver14 with the sum of the BCEs of its coarse
proposals and its refined masks (the SAM encoder frozen).

Data parallelism (catseg_tpu's shard_map step, the reference's DDP): inside
a process group (``parallel.mesh``) each rank runs the
unchanged single-GPU step on its slice of the global batch of
``cfg.batch_size``, and one ``all_reduce`` averages the loss and every
trainable gradient before the clip, as catseg_tpu's ``pmean`` precedes
``tx.update``.  The gradients travel as one flat fp32 buffer; a parameter
that got no gradient on any rank (an unused one) keeps none, as in one
process, so frozen encoders and recomputed blocks need nothing of DDP's
``find_unused_parameters``.  ``bce_loss`` is a plain mean over equal-shaped
elements, so the mean of the ranks' means is the global mean.  Only rank 0
writes metrics.json and checkpoints; a SIGINT or SIGTERM on any rank stops
every rank at the same step boundary (one ``all_reduce`` of a flag).

Class-axis model parallelism (catseg_tpu's GSPMD step on a mesh with a
class axis): the ranks of a data row share its images, and each aggregates
its slab of the classes (``aggregator_forward(class_axis=)``).  Each rank's
loss is the BCE of its slab's logits summed and divided by the element
count of the whole loss, so the ranks' losses and gradients add up to the
global ones; the one ``all_reduce`` then sums instead of averaging.  The
loss is never taken on gathered logits: every class rank would then
backpropagate the whole loss.  The parts every class rank computes alike
(CLIP, the text encoder, the top-k) get a partial gradient on each, made
whole by the sum.  Where the class count does not divide over the class
axis every class rank aggregates all classes, holds the same loss, and the
sum over the class group becomes a mean.  The fusion families shard the
same way: Ver31 its aggregator's kept classes, Ver14 its proposals and
their refinement, each of its two outputs taking its slab's share.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import CATSegConfig
from ..core.catseg import CATSeg, bce_loss, build_catseg, compute_dtype
from ..core.clip import encode_text, truncate_context
from ..parallel.mesh import INDIVISIBLE, rank, replicate, world_size
from .optim import TrainOptimizer


def class_tokens(names: list[str]) -> np.ndarray:
    """(T, 77) token ids of the train prompts: "A photo of a {name} in the
    scene" with each class's first synonym (catseg_tpu/tools/train.py)."""
    from ..text.tokenizer import tokenize

    first = [n.split(", ")[0] for n in names]
    return tokenize([f"A photo of a {n} in the scene" for n in first])


@dataclasses.dataclass
class TrainState:
    model: CATSeg
    optimizer: TrainOptimizer
    step: int = 0


def init_train_state(cfg: CATSegConfig, *, seed: int | None = None, params: dict | None = None,
                     device="cuda") -> TrainState:
    """Model (``cfg``'s :func:`~..core.catseg.model_class`, seeded random
    weights or a catseg_tpu parameter pytree) on ``device`` with the
    recipe's optimizer; raises without a GPU unless ``device="cpu"``."""
    model = build_catseg(cfg, seed=seed, params=params, device=device).train()
    return TrainState(model=model, optimizer=TrainOptimizer(cfg, model))


def train_loss(cfg: CATSegConfig, model: CATSeg, tokens: torch.Tensor, images: torch.Tensor,
               targets: torch.Tensor, class_axis=None) -> torch.Tensor:
    """Text re-encode with L2 norm, forward, BCE: the step's loss (with grad).
    Ver14 (``fusion.mode == "sam_refine"``) supervises both its proposals and
    its refined masks with the same BCE and sums the two
    (implicit_fusion_Ver14.py:413-415).  On a ``class_axis`` this rank's
    share of the global loss (the module docstring), of both outputs for
    Ver14."""
    dt = compute_dtype(cfg)
    emb = encode_text(model.clip, tokens, compute_dtype=dt)
    emb = emb / torch.linalg.vector_norm(emb.float(), dim=-1, keepdim=True).to(emb.dtype)
    targets, hw = targets.long(), tuple(targets.shape[1:3])
    # Ver14's proposals and refined masks, or the one output of the others
    kw = {"with_coarse": True} if cfg.fusion is not None and cfg.fusion.mode == "sam_refine" else {}
    if class_axis is None:
        out = model(images.float(), emb[:, None, :], **kw)
        losses = [bce_loss(logits, targets, cfg.ignore_value, hw) for logits in (out if kw else (out,))]
        return sum(losses[1:], losses[0])
    out, (t0, t1), kept = model(images.float(), emb[:, None, :], class_axis=class_axis, return_local=True, **kw)
    B, T = images.shape[0], emb.shape[0]
    count = B * class_axis.shape["data"] * hw[0] * hw[1] * T
    ids = (torch.arange(t0, t1, device=targets.device).expand(B, -1) if kept is None else kept[:, t0:t1])
    losses = [bce_loss(logits, targets, cfg.ignore_value, hw, classes=ids, count=count)
              for logits in (out if kw else (out,))]
    if kept is not None and t0 == 0:
        # the classes top-k dropped hold -100 logits in each output: a
        # constant 100 where the target is one of them (the rest rounds to
        # 0), once a data row
        valid = targets != cfg.ignore_value
        dropped = valid & ~(targets[..., None] == kept[:, None, None, :]).any(-1)
        losses = [loss + 100.0 * dropped.sum() / count for loss in losses]
    return sum(losses[1:], losses[0])


@torch.no_grad()
def all_reduce_grads_(loss: torch.Tensor, params: list[torch.Tensor], divisor: int) -> torch.Tensor:
    """Sum ``loss`` and the ``.grad`` of ``params`` over the default group
    and divide them by ``divisor`` (the world size for a mean), in place, by
    one ``all_reduce`` of a flat fp32 buffer (a presence flag a parameter
    beside its gradient).  A parameter without a gradient on every rank
    keeps ``grad=None``; one with a gradient on some ranks only raises.
    Returns the reduced loss."""
    n = world_size()
    dev = loss.device
    have = [p.grad is not None for p in params]
    sizes = [p.numel() if h else 0 for p, h in zip(params, have)]
    flat = torch.zeros(1 + len(params) + sum(sizes), dtype=torch.float32, device=dev)
    flat[0] = loss.float()
    flat[1:1 + len(params)] = torch.tensor(have, dtype=torch.float32, device=dev)
    grads = flat[1 + len(params):].split(sizes)
    for g, p, h in zip(grads, params, have):
        if h:
            g.copy_(p.grad.reshape(-1))
    dist.all_reduce(flat)
    counts = flat[1:1 + len(params)].round().long().tolist()
    if any(c not in (0, n) for c in counts) or any(c == 0 and h for c, h in zip(counts, have)):
        raise RuntimeError("a trainable parameter got a gradient on some ranks only: the ranks ran different "
                           "programs")
    flat.div_(divisor)
    for g, p, h in zip(grads, params, have):
        if h:
            p.grad.copy_(g.view_as(p.grad))
    return flat[0]


def make_train_step(cfg: CATSegConfig, optimizer: TrainOptimizer, text_tokens: np.ndarray, mesh=None):
    """Returns step(model, images, targets) -> loss: forward, backward, the
    clip and the AdamW update.  text_tokens: (T, 77) token ids of the train
    class list, cut to the longest prompt's context once here.

    Inside a process group the step is data-parallel over its ranks (at
    world size 1 too, where the all_reduce changes nothing): ``images`` /
    ``targets`` are this rank's slice (``parallel.mesh.shard_batch``, or
    ``data.mapper.train_batches(rank=, world_size=)``) and the returned loss
    is the global mean.  ``mesh``, if given, must be that group's
    (``parallel.mesh.make_mesh()``): training runs one process per device,
    so a mesh of several devices in one process raises.  A mesh with a class
    axis (``make_mesh(n_data=, n_class=)``) shards the classes over each
    data row's ranks (the module docstring); the slice is then the data
    index's.  A global batch ``cfg.batch_size`` that does not divide over
    the data axis raises, as catseg_tpu's jitted step does."""
    n = world_size()
    grouped = dist.is_initialized()
    n_class = 1 if mesh is None else mesh.n_class
    if mesh is not None and (len(mesh.devices) != 1 or mesh.ranks != n):
        raise NotImplementedError(f"training over {mesh.size} devices runs one process per device "
                                  f"(parallel.mesh.spawn); this mesh holds {len(mesh.devices)} in one process "
                                  f"of a group of {n}")
    n_data = n // n_class
    if cfg.batch_size % n_data:
        raise NotImplementedError(f"a global batch of {cfg.batch_size} does not divide over {n_data} ranks: "
                                  f"{INDIVISIBLE}")
    tokens = np.ascontiguousarray(truncate_context(np.asarray(text_tokens)), dtype=np.int64)
    class_axis = mesh if n_class > 1 else None
    # each rank's loss is a mean over its images (a data axis: the ranks'
    # mean), or its class slab's share of the global loss (a class axis: the
    # ranks' sum; the class ranks' mean where T does not divide over them)
    T = len(tokens) if cfg.pad_len <= 0 else min(len(tokens), cfg.pad_len)
    divisor = n if class_axis is None else n_class if T % n_class else 1
    on_device = {}

    def step(model: CATSeg, images, targets) -> torch.Tensor:
        dev = next(model.parameters()).device
        if dev not in on_device:
            on_device[dev] = torch.from_numpy(tokens).to(dev)
        images = torch.as_tensor(images).to(dev)
        targets = torch.as_tensor(targets).to(dev)
        loss = train_loss(cfg, model, on_device[dev], images, targets, class_axis=class_axis)
        loss.backward()
        if grouped:
            loss = all_reduce_grads_(loss, optimizer.trainable, divisor)
        optimizer.step()
        return loss.detach()

    return step


def train(state: TrainState, cfg: CATSegConfig, data_iter, text_tokens: np.ndarray, mesh=None,
          num_steps: int | None = None, log_every: int = 20, output_dir: str | None = None,
          checkpoint_every: int = 5000, eval_fn=None, eval_every: int = 5000) -> TrainState:
    """The training loop: step, log scalars to metrics.json, periodic full-state
    checkpoints (resume-capable), optional periodic eval (eval_fn(model) ->
    dict of scalars).  SIGINT / SIGTERM are deferred to step boundaries and
    leave an interrupt checkpoint.  In a process group (``data_iter``
    yielding this rank's slices) rank 0's weights are broadcast first, every
    rank steps together, and only rank 0 writes."""
    from ..utils.events import EventWriter
    from .checkpoint import save_train_state

    step_fn = make_train_step(cfg, state.optimizer, text_tokens, mesh=mesh)
    main = rank() == 0
    writer = EventWriter(output_dir if main else None, echo=main)
    grouped = dist.is_initialized()
    if grouped:
        replicate(state.model)
    dev = next(state.model.parameters()).device
    n = num_steps if num_steps is not None else cfg.max_iter - state.step
    t0 = time.time()
    loss = None

    # a signal landing inside a step would interrupt the update half-way;
    # record it and act at the next boundary (SIGTERM = preemption leaves a
    # resumable checkpoint too)
    pending = []
    prev_handlers = {}
    in_main_thread = threading.current_thread() is threading.main_thread()
    if in_main_thread:
        for s in (signal.SIGINT, signal.SIGTERM):
            prev_handlers[s] = signal.signal(s, lambda signum, frame: pending.append(signum))

    def stop() -> bool:
        # every rank learns of a signal that reached any rank, at the same boundary
        if not grouped:
            return bool(pending)
        flag = torch.tensor([float(bool(pending))], device=dev)
        dist.all_reduce(flag)
        return flag.item() > 0

    try:
        for i in range(n):
            if stop():
                raise KeyboardInterrupt
            images, targets = next(data_iter)
            loss = step_fn(state.model, images, targets)
            state.step += 1
            if log_every and (i + 1) % log_every == 0:
                writer.write(state.step, loss_sem_seg=float(loss), it_per_sec=(i + 1) / (time.time() - t0))
            if main and output_dir and state.step % checkpoint_every == 0:
                save_train_state(output_dir, state.model, state.optimizer, state.step)
            if eval_fn is not None and state.step % eval_every == 0:
                metrics = eval_fn(state.model)
                writer.write(state.step, **{f"eval/{k}": v for k, v in metrics.items()})
    except KeyboardInterrupt:
        if main and output_dir:
            save_train_state(output_dir, state.model, state.optimizer, state.step)
            writer.write(state.step, interrupted=1.0)
        raise
    finally:
        if in_main_thread:
            for s, h in prev_handlers.items():
                signal.signal(s, h)
        writer.close()
    return state
