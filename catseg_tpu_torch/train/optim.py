"""Optimizer: the reference training recipe in PyTorch (catseg_tpu/train/optim.py).

train_net.py:174-258: AdamW (base LR 2e-4, cosine, no warmup), CLIP
parameters at LR x CLIP_MULTIPLIER (0.01), the CLIP finetune policy (mode
"attention": only the q/v projection *weights* inside both CLIP transformers
train), weight decay 0 for norm-module parameters and embeddings, and a
global-norm gradient clip at 0.01 over the trainable parameters only,
applied before the update (FullModelGradientClippingOptimizer).  Labels are
computed from the port's parameter names, which are the released
checkpoints' keys.

The fusion families (catseg_tpu/train/optim.py): the second encoders
(``dino_model``, ``sam_encoder``) are frozen, as are the SAM prompt
encoder's point / not-a-point / no-mask embeddings and Fourier matrix and
the mask decoder's IoU head (implicit_fusion_Ver14.py:32-43); Ver31's
``dino_down_sample`` and ``dino_decod_proj{1,2}`` train.  The SAM modules'
norms and the decoder's output tokens take no decay.
"""

from __future__ import annotations

import math

import torch

from ..configs import CATSegConfig

CLIP_PREFIX = "sem_seg_head.predictor.clip_model."
# modules whose parameters are norm gains / biases: LayerNorms of the CLIP
# and swin / class blocks, the GroupNorms at indices 1 and 4 of each
# DoubleConv, and the SAM mask decoder's and prompt encoder's LayerNorms
_NORM_MODULES = (".norm1", ".norm2", ".guidance_norm", ".ln_1", ".ln_2", ".ln_pre", ".ln_post", "ln_final",
                 ".norm3", ".norm4", ".norm_final_attn", "mask_downscaling.1", "mask_downscaling.4",
                 "output_upscaling.1")
# nn.Embedding weights in the reference (no decay): CLIP's token embedding,
# the mask decoder's IoU and mask output tokens
_EMBEDDINGS = ("token_embedding", "sam_decoder.iou_token.", "sam_decoder.mask_tokens.")
# frozen in every fusion variant: the second encoders, the prompt encoder's
# fixed embeddings and Fourier matrix, the mask decoder's IoU head
_FUSION_FROZEN = ("dino_model.", "sam_encoder.", "sam_prompt_encoder.point_embeddings.",
                  "sam_prompt_encoder.not_a_point_embed.", "sam_prompt_encoder.no_mask_embed.",
                  "sam_prompt_encoder.pe_layer.", "sam_decoder.iou_prediction_head.")
LABELS = ("main", "main_nodecay", "clip", "clip_nodecay", "frozen")


def _is_norm(name: str) -> bool:
    if ".double_conv." in name:
        return name.split(".double_conv.")[1].split(".")[0] in ("1", "4")
    return name.rsplit(".", 1)[0].endswith(_NORM_MODULES)


def label_for_name(name: str, clip_finetune: str) -> str:
    """The optimizer group of a parameter (the JAX package's _label_for_path)."""
    def with_decay(base: str) -> str:
        return base + "_nodecay" if _is_norm(name) or any(e in name for e in _EMBEDDINGS) else base

    if name.startswith(_FUSION_FROZEN):
        return "frozen"
    if not name.startswith(CLIP_PREFIX):
        return with_decay("main")
    inside_transformer = ".resblocks." in name
    if clip_finetune == "attention":
        # q/v projection weights only (not biases, not k, not out-proj)
        if inside_transformer and name.endswith((".attn.q_proj_weight", ".attn.v_proj_weight")):
            return "clip"
        return "frozen"
    if clip_finetune == "full":
        return with_decay("clip") if inside_transformer else "frozen"
    # "prompt" (VPT) or "none": nothing of CLIP trains
    return "frozen"


def finetune_labels(model: torch.nn.Module, clip_finetune: str) -> dict[str, str]:
    return {n: label_for_name(n, clip_finetune) for n, _ in model.named_parameters()}


def cosine_lr(base_lr: float, max_iter: int):
    """detectron2 WarmupCosineLR as the released configs set it (no warmup): step -> LR."""
    return lambda step: base_lr * 0.5 * (1.0 + math.cos(math.pi * min(step, max_iter) / max_iter))


def auto_scale_config(cfg: CATSegConfig, num_devices: int) -> CATSegConfig:
    """detectron2 auto_scale_workers: batch x devices, LR x devices, iterations / devices."""
    return cfg.replace(batch_size=cfg.batch_size * num_devices, base_lr=cfg.base_lr * num_devices,
                       max_iter=int(round(cfg.max_iter / num_devices)))


@torch.no_grad()
def clip_by_global_norm_(params: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the .grad of params: scaled by
    max_norm / norm when the global norm reaches max_norm.  Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class TrainOptimizer:
    """The recipe's optimizer over ``model`` (the JAX package's
    build_optimizer): AdamW over the trainable groups with a per-group cosine
    schedule and the masked global-norm clip; frozen parameters take
    ``requires_grad_(False)`` (the JAX step's stop_gradient).  ``step()``
    clips, updates, advances the schedule and clears the gradients."""

    def __init__(self, cfg: CATSegConfig, model: torch.nn.Module):
        labels = finetune_labels(model, cfg.clip_finetune)
        groups = {k: [] for k in LABELS}
        for name, p in model.named_parameters():
            groups[labels[name]].append(p)
            p.requires_grad_(labels[name] != "frozen")
        mult = {"main": 1.0, "main_nodecay": 1.0, "clip": cfg.clip_multiplier, "clip_nodecay": cfg.clip_multiplier}
        wd = {"main": cfg.weight_decay, "main_nodecay": 0.0, "clip": cfg.weight_decay, "clip_nodecay": 0.0}
        self.labels = labels
        self.trainable = [p for k in LABELS[:-1] for p in groups[k]]
        self.clip_norm = cfg.grad_clip_norm
        self.opt = torch.optim.AdamW(
            [{"params": groups[k], "lr": cfg.base_lr * mult[k], "weight_decay": wd[k]}
             for k in LABELS[:-1] if groups[k]],
            lr=cfg.base_lr, betas=(0.9, 0.999), eps=1e-8)
        factor = cosine_lr(1.0, cfg.max_iter)
        self.sched = torch.optim.lr_scheduler.LambdaLR(self.opt, factor)

    def step(self) -> torch.Tensor:
        norm = clip_by_global_norm_(self.trainable, self.clip_norm)
        self.opt.step()
        self.sched.step()
        self.opt.zero_grad(set_to_none=True)
        return norm

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "sched": self.sched.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.sched.load_state_dict(state["sched"])

