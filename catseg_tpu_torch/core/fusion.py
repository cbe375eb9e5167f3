"""The fork's dual-encoder fusion families (catseg_tpu/core/fusion.py) as
nn.Modules.

``fusion.mode == "corr"`` (Ver31, :class:`DualEncoderCATSeg`): CLIP
(RemoteCLIP ViT-B/32) at ``fusion.clip_resolution`` (768^2, grid 24) and a
frozen DINO ViT-B/8 at ``fusion.encoder_resolution`` (384^2, grid 48).  The
DINO last layer goes through a stride-2 conv (768 -> 512) and is correlated
with the same text: a second cost volume.  Each volume takes its own 7x7
embed and an fp32 sigmoid; the two are concatenated, fused by a 7x7 conv,
an fp32 sigmoid, plus the CLIP embed as a residual.  DINO blocks 4 and 8
give a second decoder-guidance pyramid, and the FusionUP decoder adds both
pyramids' guidance halves into its first conv.  With T > pad_len each
volume keeps its own top-k classes; the logits scatter by the CLIP volume's.
The fusion-point flags ``second_corr`` / ``dual_guidance`` drop the second
volume (the plain single-volume embed) or the second pyramid; with both off
DINO does not run.

``fusion.mode == "sam_refine"`` (Ver14, :class:`SAMRefineCATSeg`): the
standard CAT-Seg model's class proposals (the raw CLIP cost, or with
``refine_from="head"`` the aggregated logits) become mask prompts, and a
SAM prompt encoder / mask decoder re-predicts each class's mask against a
SAM ViT-B embedding of the CLIP-normalized image at 1024^2: (B, T, 256, 256)
logits.

Kernels: the CLIP path (LayerNorm #1, dense attention #2), the aggregator
layers (Swin pair #4, class layer #6; Ver31 without text guidance) and,
for Ver14's head proposals, the corr embed #3 and decoder #8, all through
the port's routes.  Ver31's two embeds, its FusionUP decoder, DINO's and
SAM's attention and the mask decoder are the reference's plain compositions
(the reference runs no kernel there either); their LayerNorms take #1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs import CATSegConfig
from ..kernels.decoder import guidance_planes, up_tail
from ..ops import conv2d, conv_transpose2d_nonoverlap, resize_bilinear
from .aggregator import (Aggregator, Conv, ConvTranspose, aggregator_forward, class_aggregation,
                         correlation, corr_embed, gather_classes, l2_normalize, scatter_full_logits,
                         spatial_aggregation, topk_classes)
from .catseg import CATSeg, compute_dtype, normalize_clip
from .clip import linear
from .dino import DINO, DINO_VARIANTS, get_intermediate_layers, init_dino_
from .sam import SAM_VARIANTS, SAMEncoder, init_sam_
from .sam_decoder import MaskDecoder, PromptEncoder, dense_pe, init_prompt_decoder_


class FusionAggregator(Aggregator):
    """FusionAggregatorVer31's module tree (FusionAggregatorVer31.py:58-99):
    the base aggregator's conv1, guidance projection and layers, plus conv2
    and fusion_corr, the CLIP_ / DINO_ decoder-guidance projections and the
    Fusiondecoder1 / 2 stages, whose conv1 reads both pyramids."""

    GUIDANCE_PROJECTIONS = ("CLIP_decoder_guidance_projection", "DINO_decoder_guidance_projection")
    DECODERS = ("Fusiondecoder1", "Fusiondecoder2")

    def __init__(self, cfg: CATSegConfig):
        super().__init__(cfg)
        self.conv2 = Conv(cfg.prompt_channel, cfg.hidden_dim, 7)
        self.fusion_corr = Conv(2 * cfg.hidden_dim, cfg.hidden_dim, 7)


def _embed(corr: torch.Tensor, conv: Conv) -> torch.Tensor:
    """Per-class 7x7 conv of a cost volume: (B, T, H, W, P) -> (B, T, H, W, C)."""
    B, T, H, W, P = corr.shape
    return conv2d(corr.reshape(B * T, H, W, P), conv.weight, conv.bias, padding=3).reshape(B, T, H, W, -1)


def fusion_aggregator_forward(agg: FusionAggregator, img_feats: torch.Tensor, dino_feats: torch.Tensor | None,
                              text_feats: torch.Tensor, appearance_guidance: tuple, dino_guidance: tuple,
                              cfg: CATSegConfig) -> torch.Tensor:
    """FusionAggregatorVer31.forward: img_feats / dino_feats (B, 24, 24, E)
    (dino_feats None: ``second_corr`` off, the single-volume embed); text
    (B, T, P, E); the CLIP guidance (res3, res4, res5) and the DINO decoder
    guidance pair (or Nones) -> (B, T, 96, 96) fp32 logits, -100 for the
    classes top-k dropped."""
    T = text_feats.shape[1]
    corr = correlation(img_feats, text_feats)
    classes = None
    text_kept = text_feats
    if cfg.pad_len > 0 and T > cfg.pad_len:
        classes = topk_classes(corr, cfg.pad_len)
        text_kept = gather_classes(l2_normalize(text_feats), classes)
    if dino_feats is None:
        if classes is not None:
            corr = gather_classes(corr, classes)
        x = corr_embed(corr, agg)
    else:
        dino_corr = correlation(dino_feats, text_feats)
        if classes is not None:
            # each volume its own top-k (the logits scatter by the CLIP one's)
            dino_corr = gather_classes(dino_corr, topk_classes(dino_corr, cfg.pad_len))
            corr = gather_classes(corr, classes)
        clip_embed = torch.sigmoid(_embed(corr, agg.conv1).float()).to(corr.dtype)
        dino_embed = torch.sigmoid(_embed(dino_corr, agg.conv2).float()).to(corr.dtype)
        fused = _embed(torch.cat([clip_embed, dino_embed], dim=-1), agg.fusion_corr)
        x = torch.sigmoid(fused.float()).to(clip_embed.dtype) + clip_embed
    B, Tc, H, W = x.shape[:4]

    proj_guid = None
    if hasattr(agg, "guidance_projection"):
        gp = agg.guidance_projection[0]
        proj_guid = torch.relu(conv2d(appearance_guidance[0], gp.weight, gp.bias, padding=1))
    clip_dec = [torch.relu(conv2d(g, p[0].weight, p[0].bias, padding=1))
                for p, g in zip(agg.CLIP_decoder_guidance_projection, appearance_guidance[1:])]
    dino_dec = [None if g is None else torch.relu(conv2d(g, p[0].weight, p[0].bias, padding=1))
                for p, g in zip(agg.DINO_decoder_guidance_projection, dino_guidance)]
    text_guid = None
    if hasattr(agg, "text_guidance_projection"):
        tf = text_kept.float().mean(-2)
        tf = tf / tf.norm(dim=-1, keepdim=True)
        tp = agg.text_guidance_projection[0]
        text_guid = torch.relu(linear(tf.to(x.dtype), tp.weight, tp.bias))

    for layer in agg.layers:
        x = spatial_aggregation(x, proj_guid, layer, cfg)
        x = class_aggregation(x, text_guid, layer, cfg)
    d1, d2 = agg.Fusiondecoder1.packed(), agg.Fusiondecoder2.packed()
    xs = up_tail(x.reshape(B * Tc, H, W, -1), guidance_planes(d1, (clip_dec[0], dino_dec[0]), x.dtype), d1, None)
    logits = up_tail(xs, guidance_planes(d2, (clip_dec[1], dino_dec[1]), x.dtype), d2,
                     {"w": agg.head.weight, "b": agg.head.bias})
    logits = logits.reshape(B, Tc, *logits.shape[1:])
    if classes is not None:
        logits = scatter_full_logits(logits, classes, T)
    return logits


def _clip_and_second_images(images: torch.Tensor, cfg: CATSegConfig, normalized: bool, second_images):
    """CLIP-normalized images at the fusion CLIP resolution, and the second
    encoder's input: ``second_images`` where given (the whole-image branch
    resizes the padded canvas to each resolution on its own), else the CLIP
    image resized to the encoder resolution (the sliding-window branches)."""
    fus = cfg.fusion
    clip_images = images if normalized else normalize_clip(images)
    clip_images = resize_bilinear(clip_images, (fus.clip_resolution,) * 2)
    if second_images is None:
        second_images = resize_bilinear(clip_images, (fus.encoder_resolution,) * 2)
    return clip_images, second_images


def _broadcast_text(text_feats: torch.Tensor, B: int, dt: torch.dtype) -> torch.Tensor:
    if text_feats.ndim == 3:
        text_feats = text_feats.expand(B, *text_feats.shape)
    return text_feats.to(dt)


class DualEncoderCATSeg(CATSeg):
    """Ver31: CATSeg's CLIP, guidance pyramid and a FusionAggregator, plus the
    DINO encoder and its projections under the fork's meta-arch names
    (``dino_model``, ``dino_down_sample``, ``dino_decod_proj{1,2}``,
    implicit_fusion_Ver31.py:111,154-159)."""

    def __init__(self, cfg: CATSegConfig):
        super().__init__(cfg)
        self.sem_seg_head.predictor.transformer = FusionAggregator(cfg)
        dvar = DINO_VARIANTS[cfg.fusion.encoder]
        down = (cfg.fusion.encoder_resolution // dvar.patch) // cfg.feature_resolution[0]
        dg = cfg.decoder_guidance_dims
        self.dino_model = DINO(dvar)
        self.dino_down_sample = Conv(dvar.width, cfg.clip.embed_dim, down)
        self.dino_decod_proj1 = Conv(dvar.width, dg[0], 1)
        self.dino_decod_proj2 = ConvTranspose(dvar.width, dg[1], 2)

    def forward(self, images: torch.Tensor, text_feats: torch.Tensor, cfg: CATSegConfig | None = None,
                normalized: bool = False, second_images: torch.Tensor | None = None) -> torch.Tensor:
        """images (B, H, W, 3) raw RGB (CLIP-normalized with ``normalized``);
        text (T, P, E) or (B, T, P, E) -> (B, T, 96, 96) fp32 logits."""
        cfg = self.cfg if cfg is None else cfg
        fus = cfg.fusion
        dt = compute_dtype(cfg)
        clip_images, dino_images = _clip_and_second_images(images, cfg, normalized, second_images)
        res3, (_, res4, res5) = self.guidance_features(clip_images, cfg)
        B, H = res3.shape[:2]
        dino_feats = g1 = g2 = None
        if fus.second_corr or fus.dual_guidance:
            dvar = self.dino_model.variant
            layers = get_intermediate_layers(self.dino_model, dino_images.to(dt), compute_dtype=dt)
            g = fus.encoder_resolution // dvar.patch

            def grid(t):
                return t[:, 1:].reshape(B, g, g, -1)

            if fus.second_corr:
                dd = self.dino_down_sample
                dino_feats = conv2d(grid(layers[-1]), dd.weight, dd.bias, stride=g // H)
            if fus.dual_guidance:
                p1, p2 = self.dino_decod_proj1, self.dino_decod_proj2
                g1 = conv2d(grid(layers[fus.guidance_blocks[0]]), p1.weight, p1.bias)
                g2 = conv_transpose2d_nonoverlap(grid(layers[fus.guidance_blocks[1]]), p2.weight, p2.bias, kernel=2)
        return fusion_aggregator_forward(self.agg, res3, dino_feats, _broadcast_text(text_feats, B, dt),
                                         (res3, res4, res5), (g1, g2), cfg)

    @torch.no_grad()
    def _init_extra_(self, gen: torch.Generator) -> None:
        """catseg_tpu's init_fusion_params: DINO as init_dino_params, the
        down-sample conv and proj1 U(+-1/sqrt(fan_in)), proj2 U(+-0.02) and
        bias 0."""
        init_dino_(self.dino_model, gen)
        for conv in (self.dino_down_sample, self.dino_decod_proj1):
            bound = conv.weight[0].numel() ** -0.5
            for p in (conv.weight, conv.bias):
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
        self.dino_decod_proj2.weight.copy_((torch.rand(self.dino_decod_proj2.weight.shape, generator=gen) * 2 - 1)
                                           * 0.02)
        self.dino_decod_proj2.bias.zero_()


def _nearest_index(in_size: int, out_size: int) -> torch.Tensor:
    """torch's legacy 'nearest' source rows: floor(i * in / out) in float64."""
    i = np.arange(out_size, dtype=np.float64)
    return torch.from_numpy(np.minimum((i * in_size / out_size).astype(np.int64), in_size - 1))


def sam_mask_refine(pe: PromptEncoder, dec: MaskDecoder, coarse_logits: torch.Tensor, sam_feat: torch.Tensor,
                    chunk: int = 16) -> torch.Tensor:
    """Ver14 refinement (implicit_fusion_Ver14.py:368-398): coarse logits (B, T,
    h, w), NEAREST-upsampled to the 4 gh x 4 gw prompt grid, are each a mask
    prompt for the mask decoder against the SAM embedding (B, gh, gw, 256) ->
    (B, T, 4 gh, 4 gw) refined logits.  Classes go ``max(1, chunk // B)`` per
    image per step, as the reference's scan, so the embedding is repeated
    chunk-fold (never T-fold); the class axis is zero-padded to whole steps
    and stripped."""
    B, T, h, w = coarse_logits.shape
    gh, gw = sam_feat.shape[1:3]
    dev = coarse_logits.device
    rows, cols = _nearest_index(h, 4 * gh).to(dev), _nearest_index(w, 4 * gw).to(dev)
    prompts = coarse_logits[:, :, rows][:, :, :, cols]                # (B, T, 4gh, 4gw)
    pe_grid = dense_pe(pe.gauss, (gh, gw))
    cpi = max(1, chunk // B)
    Tp = -(-T // cpi) * cpi
    if Tp != T:
        prompts = torch.cat([prompts, prompts.new_zeros(B, Tp - T, 4 * gh, 4 * gw)], dim=1)
    feats = sam_feat.repeat_interleave(cpi, dim=0)                    # row b * cpi + c -> image b
    out = []
    for s in range(0, Tp, cpi):
        pr = prompts[:, s:s + cpi].reshape(B * cpi, 4 * gh, 4 * gw, 1)
        dense = pe.embed_masks(pr)
        sparse = dense.new_zeros(B * cpi, 0, dense.shape[-1])
        masks, _ = dec(feats, pe_grid, sparse, dense)
        out.append(masks[:, 0].reshape(B, cpi, *masks.shape[2:]))
    return torch.cat(out, dim=1)[:, :T]


class SAMRefineCATSeg(CATSeg):
    """Ver14: the whole standard model plus a SAM image encoder, prompt
    encoder and mask decoder under the meta-arch names ``sam_encoder``,
    ``sam_prompt_encoder``, ``sam_decoder`` (implicit_fusion_Ver14.py:123-125)."""

    def __init__(self, cfg: CATSegConfig):
        super().__init__(cfg)
        svar = SAM_VARIANTS[cfg.fusion.encoder]
        self.sam_encoder = SAMEncoder(svar)
        self.sam_prompt_encoder = PromptEncoder(svar.out_chans)
        self.sam_decoder = MaskDecoder(svar.out_chans)

    def forward(self, images: torch.Tensor, text_feats: torch.Tensor, cfg: CATSegConfig | None = None,
                normalized: bool = False, second_images: torch.Tensor | None = None) -> torch.Tensor:
        """images (B, H, W, 3) raw RGB (CLIP-normalized with ``normalized``)
        -> (B, T, 256, 256) fp32 refined logits.  The SAM input is the
        CLIP-normalized image, not a SAM-normalized one
        (implicit_fusion_Ver14.py:274).  For T > pad_len the top-k classes
        are refined and the rest get -100 (the reference's own pad_len
        branch cannot run: catseg_tpu's documented divergence)."""
        cfg = self.cfg if cfg is None else cfg
        fus = cfg.fusion
        dt = compute_dtype(cfg)
        clip_images, sam_images = _clip_and_second_images(images, cfg, normalized, second_images)
        img_feats, guidance = self.guidance_features(clip_images, cfg)
        text_feats = _broadcast_text(text_feats, img_feats.shape[0], dt)
        T = text_feats.shape[1]
        classes = None
        if fus.refine_from == "head":
            coarse, classes = aggregator_forward(self.agg, img_feats, text_feats, guidance, cfg, return_classes=True)
        elif fus.refine_from == "raw_corr":
            corr = correlation(img_feats, text_feats)
            if cfg.pad_len > 0 and T > cfg.pad_len:
                classes = topk_classes(corr, cfg.pad_len)
                corr = gather_classes(corr, classes)
            coarse = corr.mean(-1).float()   # template-averaged; the reference's squeeze at P = 1
        else:
            raise ValueError(f"unknown refine_from {fus.refine_from!r}")
        sam_feat = self.sam_encoder(sam_images.to(dt), compute_dtype=dt)
        refined = sam_mask_refine(self.sam_prompt_encoder, self.sam_decoder, coarse.to(dt), sam_feat,
                                  fus.refine_chunk).float()
        return refined if classes is None else scatter_full_logits(refined, classes, T)

    @torch.no_grad()
    def _init_extra_(self, gen: torch.Generator) -> None:
        init_sam_(self.sam_encoder, gen)
        init_prompt_decoder_(self.sam_prompt_encoder, self.sam_decoder, gen)


FUSION_MODELS = {"corr": DualEncoderCATSeg, "sam_refine": SAMRefineCATSeg}
