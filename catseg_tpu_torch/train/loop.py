"""Training step and loop on one device (catseg_tpu/train/loop.py).

The class text is re-encoded in every step (the text encoder is being
finetuned, cat_seg_predictor.py:209-210), so gradients flow through both
CLIP towers into their q/v projection weights.  Frozen parameters carry
``requires_grad=False`` (the JAX step's stop_gradient), so their weight
gradients are never formed and the clip never sees them.

The fusion families train as catseg_tpu's step does: Ver31 with one BCE
on its logits (DINO frozen), Ver14 with the sum of the BCEs of its coarse
proposals and its refined masks (the SAM encoder frozen).

Not ported (it raises rather than running something else): data
parallelism over a device mesh (ROADMAP A6 / A9).
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time

import numpy as np
import torch

from ..configs import CATSegConfig
from ..core.catseg import CATSeg, bce_loss, build_catseg, compute_dtype
from ..core.clip import encode_text, truncate_context
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
               targets: torch.Tensor) -> torch.Tensor:
    """Text re-encode with L2 norm, forward, BCE: the step's loss (with grad).
    Ver14 (``fusion.mode == "sam_refine"``) supervises both its proposals and
    its refined masks with the same BCE and sums the two
    (implicit_fusion_Ver14.py:413-415)."""
    dt = compute_dtype(cfg)
    emb = encode_text(model.clip, tokens, compute_dtype=dt)
    emb = emb / torch.linalg.vector_norm(emb.float(), dim=-1, keepdim=True).to(emb.dtype)
    targets, hw = targets.long(), tuple(targets.shape[1:3])
    if cfg.fusion is not None and cfg.fusion.mode == "sam_refine":
        coarse, refined = model(images.float(), emb[:, None, :], with_coarse=True)
        return bce_loss(coarse, targets, cfg.ignore_value, hw) + bce_loss(refined, targets, cfg.ignore_value, hw)
    return bce_loss(model(images.float(), emb[:, None, :]), targets, cfg.ignore_value, hw)


def make_train_step(cfg: CATSegConfig, optimizer: TrainOptimizer, text_tokens: np.ndarray, mesh=None):
    """Returns step(model, images, targets) -> loss: forward, backward, the
    clip and the AdamW update.  text_tokens: (T, 77) token ids of the train
    class list, cut to the longest prompt's context once here."""
    if mesh is not None:
        raise NotImplementedError("training over a device mesh (data parallelism) is not ported yet "
                                  "(ROADMAP A6 / A9)")
    tokens = np.ascontiguousarray(truncate_context(np.asarray(text_tokens)), dtype=np.int64)
    on_device = {}

    def step(model: CATSeg, images, targets) -> torch.Tensor:
        dev = next(model.parameters()).device
        if dev not in on_device:
            on_device[dev] = torch.from_numpy(tokens).to(dev)
        images = torch.as_tensor(images).to(dev)
        targets = torch.as_tensor(targets).to(dev)
        loss = train_loss(cfg, model, on_device[dev], images, targets)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def train(state: TrainState, cfg: CATSegConfig, data_iter, text_tokens: np.ndarray, mesh=None,
          num_steps: int | None = None, log_every: int = 20, output_dir: str | None = None,
          checkpoint_every: int = 5000, eval_fn=None, eval_every: int = 5000) -> TrainState:
    """The training loop: step, log scalars to metrics.json, periodic full-state
    checkpoints (resume-capable), optional periodic eval (eval_fn(model) ->
    dict of scalars).  SIGINT / SIGTERM are deferred to step boundaries and
    leave an interrupt checkpoint."""
    from ..utils.events import EventWriter
    from .checkpoint import save_train_state

    step_fn = make_train_step(cfg, state.optimizer, text_tokens, mesh=mesh)
    writer = EventWriter(output_dir)
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
    try:
        for i in range(n):
            if pending:
                raise KeyboardInterrupt
            images, targets = next(data_iter)
            loss = step_fn(state.model, images, targets)
            state.step += 1
            if log_every and (i + 1) % log_every == 0:
                writer.write(state.step, loss_sem_seg=float(loss), it_per_sec=(i + 1) / (time.time() - t0))
            if output_dir and state.step % checkpoint_every == 0:
                save_train_state(output_dir, state.model, state.optimizer, state.step)
            if eval_fn is not None and state.step % eval_every == 0:
                metrics = eval_fn(state.model)
                writer.write(state.step, **{f"eval/{k}": v for k, v in metrics.items()})
    except KeyboardInterrupt:
        if output_dir:
            save_train_state(output_dir, state.model, state.optimizer, state.step)
            writer.write(state.step, interrupted=1.0)
        raise
    finally:
        if in_main_thread:
            for s, h in prev_handlers.items():
                signal.signal(s, h)
        writer.close()
    return state
