"""Configurations and class lists of the port.

The port's own copy of catseg_tpu/configs.py (host code, no JAX): the
CLIP variants, the flat ``CATSegConfig`` dataclass with its presets
(``vitb384``, ``vitl336``, ``vith336``, ``vitg336``) and ``eval_preset``, and
the pixel statistics.  ``dataclasses.asdict`` of every preset equals the JAX
package's (tests/test_torch_host.py).  The benchmarks' class lists ship under
``data/class_jsons/``.  The fork's fusion presets are not ported; their
``FusionConfig`` stays so the dataclass keeps the same fields.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class CLIPVariant:
    """Architecture hyperparameters of an OpenAI-style CLIP."""

    name: str
    patch: int
    width: int
    layers: int
    heads: int
    embed_dim: int
    pretrain_res: int
    text_width: int
    text_heads: int
    text_layers: int
    vocab_size: int = 49408
    context: int = 77
    # OpenAI CLIP uses QuickGELU; open_clip's laion-trained H/G use exact GELU
    act: str = "quick_gelu"
    # visual-tower MLP expansion (open_clip ViT-bigG-14 ships 4.9231 -> 8192)
    mlp_ratio: float = 4.0

    @property
    def pretrain_grid(self) -> int:
        return self.pretrain_res // self.patch

    @property
    def mlp_width(self) -> int:
        return int(self.width * self.mlp_ratio)


VITB16 = CLIPVariant("ViT-B/16", 16, 768, 12, 12, 512, 224, 512, 8, 12)
VITL14_336 = CLIPVariant("ViT-L/14@336px", 14, 1024, 24, 16, 768, 336, 768, 12, 12)
VITB32 = CLIPVariant("ViT-B/32", 32, 768, 12, 12, 512, 224, 512, 8, 12)  # RemoteCLIP backbone
# OpenCLIP tiers the reference supports via open_clip (cat_seg_predictor.py:64-76).
# Published laion2b checkpoints ship 224-grid pos embeds; force_image_size=336
# there means the pos embed is bicubically resized to the 24x24 grid at load —
# our converter does the same (weights/convert.py:convert_openclip_state_dict),
# so pretrain_res here is the *running* grid, 336.
VITH14 = CLIPVariant("ViT-H-14", 14, 1280, 32, 16, 1024, 336, 1024, 16, 24, act="gelu")
VITG14 = CLIPVariant("ViT-bigG-14", 14, 1664, 48, 16, 1280, 336, 1280, 20, 32,
                     act="gelu", mlp_ratio=4.9231)

CLIP_VARIANTS = {v.name: v for v in (VITB16, VITL14_336, VITB32, VITH14, VITG14)}

# image normalization (reference: cat_seg/config.py CLIP_PIXEL_* and configs PIXEL_*)
PIXEL_MEAN = (123.675, 116.280, 103.530)
PIXEL_STD = (58.395, 57.120, 57.375)
CLIP_PIXEL_MEAN = (122.7709383, 116.7460125, 104.09373615)
CLIP_PIXEL_STD = (68.5005327, 66.6321579, 70.3231630)


@dataclass(frozen=True)
class FusionConfig:
    """Optional second-encoder fusion pathway (reference fork Ver31/Ver14
    families collapsed into one parameterized path, see SURVEY.md §2.4).

    mode="corr" is the Ver31 dual-correlation family (DINO second cost
    volume + dual decoder guidance); mode="sam_refine" is the Ver14 family
    (a frozen SAM image encoder + trainable prompt-encoder/mask-decoder
    refine per-class mask proposals, implicit_fusion_Ver14.py:28-46,368-398)."""

    mode: str = "corr"  # "corr" (Ver31) | "sam_refine" (Ver14)
    encoder: str = "dino_vitb8"  # "sam_vitb" for mode="sam_refine"
    second_corr: bool = True  # second correlation volume + fusion conv
    dual_guidance: bool = True  # second decoder-guidance pyramid
    encoder_resolution: int = 384  # 1024 for SAM (implicit_fusion_Ver14.py:148)
    clip_resolution: int = 768  # Ver31 runs CLIP at 768^2
    guidance_blocks: tuple[int, int] = (3, 7)  # dino_feat[3]/[7] (Ver31:301-302)
    # sam_refine knobs
    refine_from: str = "raw_corr"  # proposals: "raw_corr" (Ver14 bypasses the
    # aggregator, FusionAggregator.py:5011-5016) | "head" (aggregated logits)
    refine_chunk: int = 16  # classes per mask-decoder dispatch (lax.scan)


@dataclass(frozen=True)
class CATSegConfig:
    clip: CLIPVariant = VITB16
    clip_resolution: int = 384  # 384 for B/16, 336 for L/14 (cat_seg_model.py:78)
    guidance_layers: tuple[int, int] = (3, 7)  # (7, 15) for L/14 (cat_seg_model.py:84)
    guidance_proj_dim: int = 768  # vision width; ConvT inputs (cat_seg_model.py:80-82)

    # aggregator (configs/vitb_384.yaml / vitl_336.yaml SEM_SEG_HEAD block)
    text_guidance_dim: int = 512
    text_guidance_proj_dim: int = 128
    appearance_guidance_dim: int = 512
    appearance_guidance_proj_dim: int = 128
    decoder_dims: tuple[int, int] = (64, 32)
    decoder_guidance_dims: tuple[int, int] = (256, 128)
    decoder_guidance_proj_dims: tuple[int, int] = (32, 16)
    num_layers: int = 2
    num_heads: int = 4
    hidden_dim: int = 128
    pooling_size: tuple[int, int] = (2, 2)
    feature_resolution: tuple[int, int] = (24, 24)
    window_size: int = 12
    attention_type: str = "linear"
    pad_len: int = 256
    prompt_ensemble_type: str = "single"

    # inference
    sliding_window: bool = False
    sw_out_res: int = 640
    sw_kernel: int = 384
    sw_overlap: float = 0.333

    # training (configs/config.yaml SOLVER + INPUT)
    ignore_value: int = 255
    num_classes: int = 171
    clip_finetune: str = "attention"
    base_lr: float = 2e-4
    max_iter: int = 80000
    weight_decay: float = 1e-4
    clip_multiplier: float = 0.01
    backbone_multiplier: float = 0.0
    grad_clip_norm: float = 0.01
    batch_size: int = 4
    crop_size: int = 384
    min_size_test: int = 640
    max_size_test: int = 2560
    color_aug: bool = True

    compute_dtype: str = "bfloat16"
    # fused decoder kernel (kernels/decoder.py) on CUDA at the flagship
    # geometry; False keeps the plain _up_tail pair
    fused_decoder: bool = True
    fusion: FusionConfig | None = None

    @property
    def sw_stride(self) -> int:
        return int(self.sw_kernel * (1 - self.sw_overlap))

    @property
    def prompt_channel(self) -> int:
        from .text import templates

        return len(templates.get(self.prompt_ensemble_type))

    def replace(self, **kw) -> "CATSegConfig":
        return dataclasses.replace(self, **kw)


def vitb384(**kw) -> CATSegConfig:
    """CAT-Seg (B): ViT-B/16 @ 384 (configs/vitb_384.yaml)."""
    return CATSegConfig(**kw)


def vitl336(**kw) -> CATSegConfig:
    """CAT-Seg (L): ViT-L/14@336px (configs/vitl_336.yaml)."""
    base = dict(
        clip=VITL14_336,
        clip_resolution=336,
        guidance_layers=(7, 15),
        guidance_proj_dim=1024,
        text_guidance_dim=768,
        appearance_guidance_dim=768,
    )
    base.update(kw)
    return CATSegConfig(**base)


def vith336(**kw) -> CATSegConfig:
    """CAT-Seg (H): OpenCLIP ViT-H-14 @ 336 (cat_seg_predictor.py:64-76;
    guidance taps stay [7, 15] for every non-B/16 variant,
    cat_seg_model.py:84)."""
    base = dict(
        clip=VITH14,
        clip_resolution=336,
        guidance_layers=(7, 15),
        guidance_proj_dim=1280,
        text_guidance_dim=1024,
        appearance_guidance_dim=1024,
    )
    base.update(kw)
    return CATSegConfig(**base)


def vitg336(**kw) -> CATSegConfig:
    """CAT-Seg (G): OpenCLIP ViT-bigG-14 @ 336."""
    base = dict(
        clip=VITG14,
        clip_resolution=336,
        guidance_layers=(7, 15),
        guidance_proj_dim=1664,
        text_guidance_dim=1280,
        appearance_guidance_dim=1280,
    )
    base.update(kw)
    return CATSegConfig(**base)


# the fields a CATSeg model is built from: its parameters' shapes, and the
# function its weights were trained to compute.  A run-time config handed in
# beside a model (a Predictor's) may differ from the model's only elsewhere:
# the sliding window, pooling, dtype, prompts, routes and training recipe.
ARCHITECTURE_FIELDS = ("clip", "clip_resolution", "guidance_layers", "guidance_proj_dim", "text_guidance_dim",
                       "text_guidance_proj_dim", "appearance_guidance_dim", "appearance_guidance_proj_dim",
                       "decoder_dims", "decoder_guidance_dims", "decoder_guidance_proj_dims", "num_layers",
                       "num_heads", "hidden_dim", "feature_resolution", "window_size", "attention_type", "pad_len",
                       "fusion")


def check_same_architecture(cfg: CATSegConfig, model_cfg: CATSegConfig) -> None:
    """Raise ValueError where ``cfg`` and a model's ``model_cfg`` disagree on
    an :data:`ARCHITECTURE_FIELDS` field."""
    bad = [f for f in ARCHITECTURE_FIELDS if getattr(cfg, f) != getattr(model_cfg, f)]
    if bad:
        raise ValueError(f"the config disagrees with the model's on {bad}: only run-time fields may differ")


def eval_preset(cfg: CATSegConfig) -> CATSegConfig:
    """The eval.sh protocol: sliding window + POOLING_SIZES [1,1]."""
    return cfg.replace(sliding_window=True, pooling_size=(1, 1))


_CLASS_JSONS = Path(__file__).resolve().parent / "data" / "class_jsons"


def class_names(benchmark: str) -> list[str]:
    """The class names of a benchmark, e.g. ``class_names("ade150")`` (150 names)."""
    return json.loads((_CLASS_JSONS / f"{benchmark}.json").read_text())
