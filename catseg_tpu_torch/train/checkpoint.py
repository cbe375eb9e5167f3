"""Full training-state checkpoints: parameters, optimizer state and step
(catseg_tpu/train/checkpoint.py, detectron2's resume semantics: periodic
saves and a ``last_checkpoint`` pointer file).  The blob is ``torch.save``
of state dicts, not the JAX package's msgpack."""

from __future__ import annotations

import os

import torch


def save_train_state(output_dir: str, model: torch.nn.Module, optimizer, step: int) -> str:
    """Write model_{step:07d}.ckpt (through .tmp + os.replace) and point
    last_checkpoint at it; returns its path."""
    os.makedirs(output_dir, exist_ok=True)
    name = f"model_{step:07d}.ckpt"
    path = os.path.join(output_dir, name)
    torch.save({"params": model.state_dict(), "opt_state": optimizer.state_dict(), "step": step}, path + ".tmp")
    os.replace(path + ".tmp", path)
    with open(os.path.join(output_dir, "last_checkpoint"), "w") as f:
        f.write(name)
    return path


def load_train_state(path: str, model: torch.nn.Module, optimizer) -> int:
    """Restore model and optimizer in place (shapes must match); returns the step."""
    blob = torch.load(path, map_location=next(model.parameters()).device, weights_only=True)
    model.load_state_dict(blob["params"], strict=True)
    optimizer.load_state_dict(blob["opt_state"])
    return int(blob["step"])


def latest_checkpoint(output_dir: str) -> str | None:
    pointer = os.path.join(output_dir, "last_checkpoint")
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    path = os.path.join(output_dir, name)
    return path if os.path.exists(path) else None
