"""Training CLI, the train_net.py equivalent (catseg_tpu/tools/train.py).

    python -m catseg_tpu_torch.tools.train --config vitb384 --output out/ \
        [--steps N] [--resume] [--dataset coco_2017_train_stuff_all_sem_seg] [--device cpu] [KEY=VALUE ...]

The reference recipe: COCO-Stuff-171 crops at 384^2 through the train mapper
(``data.mapper.train_batches`` in a prefetch thread), AdamW 2e-4 cosine over
80k steps, CLIP LR x0.01 with attention-mode finetuning, full-model grad
clip 0.01, batch 4, on one device.  Writes metrics.json, resumable
``model_*.ckpt`` checkpoints and ``model_final.pth`` ({"model": state_dict},
the reference's checkpoint layout; ``tools.eval --checkpoint`` reads it).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.catalogs import get_dataset, load_class_names
from ..data.loader import GeneratorPrefetcher, list_dataset
from ..data.mapper import train_batches
from ..train.loop import TrainState, class_tokens, train
from ..train.optim import TrainOptimizer
from .common import add_device_arg, load_params, resolve_config


def main(argv=None) -> TrainState:
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--config", default="vitb384")
    ap.add_argument("--output", default="output")
    ap.add_argument("--dataset", default="coco_2017_train_stuff_all_sem_seg")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--steps", type=int, default=None, help="default: cfg.max_iter")
    ap.add_argument("--checkpoint", default=None,
                    help="initial weights: a released / OpenAI / open_clip .pth, .pt or .bin, the port's .pth, or a "
                         "catseg_tpu .npz")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-dataset", default=None, help="periodic eval (TEST.EVAL_PERIOD)")
    ap.add_argument("--eval-limit", type=int, default=200)
    ap.add_argument("--eval-every", type=int, default=5000)
    ap.add_argument("--auto-scale", action="store_true",
                    help="scale batch with the device count (detectron2 auto_scale_workers); waits for "
                         "multi-GPU training (ROADMAP A6)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    cfg = resolve_config(args.config, args.overrides)
    if args.auto_scale and args.device == "cuda" and torch.cuda.device_count() > 1:
        print(f"--auto-scale: {torch.cuda.device_count()} GPUs visible, but the port trains on one device "
              "(multi-GPU training waits for ROADMAP A6); batch, LR and iterations stay as configured")
    os.makedirs(args.output, exist_ok=True)

    model = load_params(args.checkpoint, cfg, seed=args.seed, device=args.device).train()
    state = TrainState(model=model, optimizer=TrainOptimizer(cfg, model))

    spec = get_dataset(args.dataset)
    tokens = class_tokens(load_class_names(spec.class_json))
    pairs = list_dataset(spec, root=args.data_root)
    if not pairs:
        raise FileNotFoundError(f"no data for {spec.name} under root {args.data_root}")
    rng = np.random.default_rng(args.seed)
    data = GeneratorPrefetcher(train_batches(pairs, cfg.batch_size, rng, crop_size=cfg.crop_size,
                                             color_aug=cfg.color_aug, ignore=cfg.ignore_value))

    if args.resume:
        from ..train.checkpoint import latest_checkpoint, load_train_state

        last = latest_checkpoint(args.output)
        if last:
            state.step = load_train_state(last, state.model, state.optimizer)
            print(f"resumed from {last} at step {state.step}")

    eval_fn = None
    if args.eval_dataset:
        from ..evaluation.harness import evaluate_benchmark

        def eval_fn(model):
            model.eval()
            try:
                m = evaluate_benchmark(model, cfg, args.eval_dataset, root=args.data_root,
                                       limit=args.eval_limit, verbose=False)
            finally:
                model.train()
            return {k: m[k] for k in ("mIoU", "fwIoU", "mACC", "pACC")}

    try:
        train(state, cfg, data, tokens, num_steps=args.steps, output_dir=args.output, eval_fn=eval_fn,
              eval_every=args.eval_every)
    finally:
        data.close()
    final = os.path.join(args.output, "model_final.pth")
    torch.save({"model": state.model.state_dict()}, final)
    print(f"saved {final}")
    return state


if __name__ == "__main__":
    main()
