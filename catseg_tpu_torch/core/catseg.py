"""The CAT-Seg model (catseg_tpu/core/catseg.py) as an nn.Module.

``build_catseg(cfg, seed=0)`` gives the model on the card;
``CATSeg(cfg)(images, text_feats)`` maps raw (B, H, W, 3) RGB tiles and
(T, P, E) text features to (B, T, 96, 96) fp32 logits: CLIP normalization,
resize to clip_resolution, dense CLIP encode with guidance taps, the
guidance pyramid (upsample1 ConvT k2 width->256, upsample2 ConvT k4
width->128) and the aggregator.  Attribute names follow
``weights.export.export_catseg_checkpoint`` keys.  A config with ``fusion``
builds the fork's dual-encoder model of its mode instead (core/fusion.py,
:func:`model_class`).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs import CATSegConfig, CLIP_PIXEL_MEAN, CLIP_PIXEL_STD
from ..ops import conv_transpose2d_nonoverlap, resize_bilinear
from .aggregator import Aggregator, Conv, ConvTranspose, aggregator_forward
from .clip import CLIP, Linear, encode_image, init_clip_

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: CATSegConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def normalize_clip(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) raw RGB [0, 255] -> CLIP-normalized fp32."""
    mean = torch.tensor(CLIP_PIXEL_MEAN, device=images.device)
    std = torch.tensor(CLIP_PIXEL_STD, device=images.device)
    return (images.float() - mean) / std


class CATSeg(nn.Module):
    def __init__(self, cfg: CATSegConfig):
        super().__init__()
        self.cfg = cfg
        self.sem_seg_head = nn.Module()
        self.sem_seg_head.predictor = nn.Module()
        self.sem_seg_head.predictor.clip_model = CLIP(cfg.clip)
        self.sem_seg_head.predictor.transformer = Aggregator(cfg)
        pd = cfg.guidance_proj_dim
        self.upsample1 = ConvTranspose(pd, cfg.decoder_guidance_dims[0], 2)
        self.upsample2 = ConvTranspose(pd, cfg.decoder_guidance_dims[1], 4)

    @property
    def clip(self) -> CLIP:
        return self.sem_seg_head.predictor.clip_model

    @property
    def agg(self) -> Aggregator:
        return self.sem_seg_head.predictor.transformer

    def guidance_features(self, clip_images: torch.Tensor, cfg: CATSegConfig | None = None):
        """Dense CLIP encode + guidance pyramid of normalized, resized images.
        Returns (img_feats (B, 24, 24, E), (res3, res4, res5)).  ``cfg``
        (default: the model's) may differ from the model's in its run-time
        fields (sliding_window, pooling_size), as eval_preset's does."""
        cfg = self.cfg if cfg is None else cfg
        dt = compute_dtype(cfg)
        tokens, taps = encode_image(self.clip, clip_images.to(dt), taps=cfg.guidance_layers,
                                    compute_dtype=dt)
        H, W = cfg.feature_resolution
        B = tokens.shape[0]
        res3 = tokens[:, 1:].reshape(B, H, W, -1)
        res4 = taps[0][:, 1:].reshape(B, H, W, -1)
        res5 = taps[1][:, 1:].reshape(B, H, W, -1)
        res4 = conv_transpose2d_nonoverlap(res4, self.upsample1.weight, self.upsample1.bias, kernel=2)
        res5 = conv_transpose2d_nonoverlap(res5, self.upsample2.weight, self.upsample2.bias, kernel=4)
        return res3, (res3, res4, res5)

    def forward(self, images: torch.Tensor, text_feats: torch.Tensor,
                cfg: CATSegConfig | None = None) -> torch.Tensor:
        """images (B, H, W, 3) raw RGB; text_feats (T, P, E) or (B, T, P, E);
        ``cfg`` as :meth:`guidance_features` takes it."""
        cfg = self.cfg if cfg is None else cfg
        clip_images = resize_bilinear(normalize_clip(images), (cfg.clip_resolution,) * 2)
        img_feats, guidance = self.guidance_features(clip_images, cfg)
        if text_feats.ndim == 3:
            text_feats = text_feats.expand(images.shape[0], *text_feats.shape)
        return aggregator_forward(self.agg, img_feats, text_feats.to(compute_dtype(cfg)), guidance, cfg)

    def _init_extra_(self, gen: torch.Generator) -> None:
        """Seeded init of the modules a subclass adds (the fusion families')."""


def model_class(cfg: CATSegConfig) -> type[CATSeg]:
    """CATSeg, or for ``cfg.fusion`` the fusion family of its mode (Ver31
    ``DualEncoderCATSeg``, Ver14 ``SAMRefineCATSeg``)."""
    if cfg.fusion is None:
        return CATSeg
    from .fusion import FUSION_MODELS

    if cfg.fusion.mode not in FUSION_MODELS:
        raise ValueError(f"unknown fusion mode {cfg.fusion.mode!r}")
    return FUSION_MODELS[cfg.fusion.mode]


def bce_loss(logits: torch.Tensor, targets: torch.Tensor, ignore_value: int,
             out_hw: tuple[int, int]) -> torch.Tensor:
    """Per-pixel multi-label BCE (catseg_tpu/core/catseg.py bce_loss;
    cat_seg_model.py:189-203): (B, T, 96, 96) logits upsampled bilinearly to
    (H, W) in fp32, a one-hot target that is all-negative on ignored pixels,
    a stable BCE-with-logits averaged over every element."""
    T = logits.shape[1]
    x = resize_bilinear(logits.permute(0, 2, 3, 1).float(), out_hw)
    valid = targets != ignore_value
    onehot = F.one_hot(torch.where(valid, targets, 0), T).float() * valid[..., None]
    loss = x.clamp_min(0) - x * onehot + torch.log1p(torch.exp(-x.abs()))
    return loss.mean()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another; asking for CUDA without a card raises instead of running on
    the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on an NVIDIA GPU by default; "
                           "pass device='cpu' to run its plain PyTorch path")
    return device


def build_catseg(cfg: CATSegConfig, *, seed: int | None = None, params: dict | None = None,
                 device="cuda") -> CATSeg:
    """A CATSeg (or the :func:`model_class` of a fusion config) in eval mode
    on ``device``: seeded random weights (:func:`init_catseg_`) or a
    catseg_tpu parameter pytree (``params``)."""
    if (seed is None) == (params is None):
        raise ValueError("build_catseg takes exactly one of seed= and params=")
    device = resolve_device(device)
    model = model_class(cfg)(cfg)
    if params is not None:
        from ..weights.from_jax import load_params_

        load_params_(model, params)
    else:
        init_catseg_(model, seed)
    return model.to(device).eval()


@torch.no_grad()
def init_catseg_(model: CATSeg, seed: int) -> CATSeg:
    """Seeded random init through a CPU torch.Generator (device independent):
    CLIP as catseg_tpu's init_clip_params; every aggregator linear / conv
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)); norms 1 / 0; padding rows 0; then
    a fusion model's own modules (``_init_extra_``)."""
    gen = torch.Generator().manual_seed(seed)

    def uniform_(p, bound):
        p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)

    init_clip_(model.clip, gen)
    for m in list(model.agg.modules()) + [model.upsample1, model.upsample2]:
        if isinstance(m, (Linear, Conv, ConvTranspose)):
            fan_in = m.weight.shape[1] if isinstance(m, Linear) else m.weight[0].numel()
            if isinstance(m, ConvTranspose):
                fan_in = m.weight.shape[0] * m.weight.shape[2] * m.weight.shape[3]
            uniform_(m.weight, fan_in ** -0.5)
            if m.bias is not None:
                uniform_(m.bias, fan_in ** -0.5)
    for name, p in model.agg.named_parameters():
        if name.endswith(("padding_tokens", "padding_guidance")):
            p.zero_()
    model._init_extra_(gen)
    return model
