"""Inference (catseg_tpu/infer/pipeline.py): the sliding-window and the
whole-image branches, and the Predictor that serves them.

Sliding window, per image: bilinear resize of the true-size image to sw_out_res (640) and
sw_kernel (384) -> 4 tiles (kernel 384, stride 256) + 1 global tile -> one
model forward for all tiles of the batch -> per tile 96 -> 384 bilinear
logits, sigmoid, fold with the overlap divisor -> average with the global
tile upsampled to 640 -> bilinear resize to the true size and argmax over
classes in chunks with a strict ``>`` running max.

bf16 compute carries the probabilities in bf16 as the reference does
(sigmoid and the resize arithmetic stay fp32); fp32 compute keeps an fp32
tail.

Whole image (``cfg.sliding_window=False``, the model's default): the image
is CLIP-normalized, zero-padded to multiples of crop_size (the reference's
ImageList size divisibility), resized to clip_resolution, encoded and
aggregated once; the fp32 sigmoid gives (96, 96, T) probabilities in both
compute dtypes.

The fork's fusion models (core/fusion.py) serve through the same paths: the
sliding batch hands them raw tiles (each derives its second encoder's input
from its CLIP image), the whole-image branch hands them the padded canvas
resized to each encoder's resolution.  Ver14's (256, 256) refined logits
take the same resize-to-kernel tail as (96, 96) ones.

The reference's static-canvas machinery exists for XLA's static shapes and
is not needed here: every image is resized at its own size.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import CATSegConfig, check_same_architecture
from ..core.aggregator import aggregator_forward
from ..core.catseg import CATSeg, compute_dtype, normalize_clip, resolve_device
from ..ops import fold_divisor, fold_tiles, resize_bilinear, unfold_tiles
from ..text.embed import forward_text_embeds


def _resize_cm(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of a class-major (N, T, h, w) tensor, fp32 arithmetic."""
    return resize_bilinear(x.permute(0, 2, 3, 1), out_hw).permute(0, 3, 1, 2)


def sliding_window_probs_batch(model: CATSeg, image640s: torch.Tensor, image_globals: torch.Tensor,
                               text_feats: torch.Tensor, cfg: CATSegConfig) -> torch.Tensor:
    """(n, 640, 640, 3) + (n, 384, 384, 3) raw RGB -> (n, T, 640, 640)
    class-major sigmoid probabilities in the carrier dtype."""
    k, s, out = cfg.sw_kernel, cfg.sw_stride, cfg.sw_out_res
    n = image640s.shape[0]
    nt = ((out - k) // s + 1) ** 2
    batch = torch.cat([unfold_tiles(image640s, k, s), image_globals], dim=0)
    logits = model(batch, text_feats, cfg)                   # ((nt+1)*n, T, 96, 96) fp32
    pdt = compute_dtype(cfg)
    fast = pdt == torch.bfloat16
    div = fold_divisor((out, out), k, s, device=logits.device)[..., 0]
    if fast:
        div = div.to(pdt)
    res = []
    for i in range(n):
        lg = logits[[j * n + i for j in range(nt)] + [nt * n + i]]
        lg = _resize_cm(lg.to(pdt) if fast else lg, (k, k))
        probs = torch.sigmoid(lg.float())
        if fast:
            probs = probs.to(pdt)
        folded = fold_tiles(probs[:nt].permute(0, 2, 3, 1), (out, out), k, s)[0].permute(2, 0, 1)
        folded = folded / div
        global_up = _resize_cm(probs[nt:], (out, out))[0]
        res.append((folded + global_up) / 2.0)
    return torch.stack(res)


def normalize_clip_padded(image: torch.Tensor, div: int) -> torch.Tensor:
    """(H, W, 3) raw RGB -> CLIP-normalized fp32, zero-padded at the bottom
    and right to (ceil(H / div) * div, ceil(W / div) * div)."""
    H, W = image.shape[:2]
    img = normalize_clip(image)
    return F.pad(img, (0, 0, 0, -W % div, 0, -H % div))


def whole_image_probs(model: CATSeg, image: torch.Tensor, text_feats: torch.Tensor,
                      cfg: CATSegConfig) -> torch.Tensor:
    """(H, W, 3) raw RGB -> (96, 96, T) fp32 sigmoid probabilities of one
    model forward (resized to clip_resolution without padding)."""
    logits = model(image[None], text_feats, cfg)[0]
    return torch.sigmoid(logits.float()).permute(1, 2, 0)


def whole_image_probs_padded(model: CATSeg, image: torch.Tensor, text_feats: torch.Tensor,
                             cfg: CATSegConfig) -> torch.Tensor:
    """The whole-image branch (cat_seg_model.py:147-155,220-229; catseg_tpu's
    whole_image_probs_from_canvas at the image's true size): (H, W, 3) raw
    RGB -> normalized and zero-padded to crop_size multiples -> bilinear
    resize of the padded tensor to clip_resolution (fp32) -> CLIP with
    guidance taps -> aggregator with the text in the compute dtype -> fp32
    sigmoid, (96, 96, T).  A fusion model (catseg_tpu's fusion canvas branch,
    implicit_fusion_Ver31.py:239-240) takes the padded tensor resized to the
    fusion CLIP resolution and, on its own, to the second encoder's: (96,
    96, T) for Ver31, (256, 256, T) for Ver14's refined masks.  ``cfg`` may
    differ from ``model.cfg`` in run-time fields only (ValueError)."""
    check_same_architecture(cfg, model.cfg)
    img = normalize_clip_padded(image, cfg.crop_size)
    if cfg.fusion is not None:
        clip_img = resize_bilinear(img[None], (cfg.fusion.clip_resolution,) * 2)
        second = resize_bilinear(img[None], (cfg.fusion.encoder_resolution,) * 2)
        logits = model(clip_img, text_feats, cfg, normalized=True, second_images=second)[0]
        return torch.sigmoid(logits.float()).permute(1, 2, 0)
    img = resize_bilinear(img[None], (cfg.clip_resolution,) * 2)
    img_feats, guidance = model.guidance_features(img, cfg)
    tf = text_feats[None] if text_feats.ndim == 3 else text_feats
    logits = aggregator_forward(model.agg, img_feats, tf.to(compute_dtype(cfg)), guidance, cfg)[0]
    return torch.sigmoid(logits.float()).permute(1, 2, 0)


def resize_argmax(probs_cm: torch.Tensor, out_hw, chunk: int = 32) -> torch.Tensor:
    """(T, h, w) probs -> (H, W) int32 argmax of their bilinear resize, over
    class chunks with a strict ``>`` running max (ties keep the lower class)."""
    H, W = out_hw
    best = torch.full((H, W), float("-inf"), device=probs_cm.device)
    pred = torch.zeros((H, W), dtype=torch.int32, device=probs_cm.device)
    for c0 in range(0, probs_cm.shape[0], chunk):
        r = F.interpolate(probs_cm[None, c0:c0 + chunk].float(), size=(H, W), mode="bilinear",
                          align_corners=False)[0]
        cmax = r.amax(0)
        cidx = r.argmax(0).to(torch.int32) + c0
        take = cmax > best
        best = torch.where(take, cmax, best)
        pred = torch.where(take, cidx, pred)
    return pred


class Predictor:
    """predict(image) -> {"sem_seg": (T, H, W) probs} or an argmax map, and
    the sliding-window batch paths for lists of true-size RGB images.

    The model and the text features move to ``device``, the card unless the
    caller asks for the CPU; without a card the default raises.  Unlike
    catseg_tpu's Predictor it takes no ``input_canvas`` (nor
    ``predict_argmax``'s ``canvas``): those fix XLA's static shapes, and
    here every image runs at its own size.  ``mesh`` (tile-sharded latency)
    waits for the port's multi-GPU work (ROADMAP A6).  ``cfg`` may differ
    from ``model.cfg`` only in run-time fields (``eval_preset``'s sliding
    window and pooling, the dtype); an architecture field raises."""

    def __init__(self, model: CATSeg, cfg: CATSegConfig, class_names: list[str],
                 text_feats: torch.Tensor | np.ndarray | None = None, device="cuda"):
        check_same_architecture(cfg, model.cfg)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.class_names = list(class_names)
        if text_feats is None:
            with torch.inference_mode():
                text_feats = forward_text_embeds(model.clip, self.class_names, cfg.prompt_ensemble_type,
                                                 compute_dtype=compute_dtype(cfg))
        self.text_feats = torch.as_tensor(text_feats, dtype=torch.float32, device=self.device)

    def _inputs(self, images: list[np.ndarray]):
        k, out = self.cfg.sw_kernel, self.cfg.sw_out_res
        big, small = [], []
        for im in images:
            t = self._image(im)[None]
            big.append(resize_bilinear(t, (out, out)))
            small.append(resize_bilinear(t, (k, k)))
        return torch.cat(big), torch.cat(small)

    def _probs_cm(self, images: list[np.ndarray]) -> torch.Tensor:
        img640s, imgks = self._inputs(images)
        return sliding_window_probs_batch(self.model, img640s, imgks, self.text_feats, self.cfg)

    def _image(self, image: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(image), device=self.device).float()

    @torch.inference_mode()
    def probs_whole(self, image: np.ndarray) -> torch.Tensor:
        """One (H, W, 3) image -> (96, 96, T) fp32 probs, whole-image branch."""
        return whole_image_probs_padded(self.model, self._image(image), self.text_feats, self.cfg)

    def probs_sliding(self, image: np.ndarray) -> torch.Tensor:
        """One (H, W, 3) image -> (640, 640, T) probs: the batch path's row."""
        return self.probs_sliding_batch([image])[0]

    def probs(self, image: np.ndarray) -> torch.Tensor:
        """The branch cfg.sliding_window names, as the reference meta-arch."""
        return self.probs_sliding(image) if self.cfg.sliding_window else self.probs_whole(image)

    @torch.inference_mode()
    def predict(self, image: np.ndarray, out_hw: tuple[int, int] | None = None) -> dict:
        """Class probabilities at the image's size (or ``out_hw``): {"sem_seg":
        (T, H, W) fp32 numpy}, a bilinear fp32 resize of :meth:`probs`."""
        H, W = out_hw or image.shape[:2]
        up = resize_bilinear(self.probs(image)[None].float(), (H, W))[0]
        return {"sem_seg": up.permute(2, 0, 1).cpu().numpy()}

    @torch.inference_mode()
    def predict_argmax(self, image: np.ndarray, out_hw: tuple[int, int] | None = None) -> np.ndarray:
        """(H, W) int32 argmax map at the image's size (or ``out_hw``)."""
        H, W = out_hw or image.shape[:2]
        return resize_argmax(self.probs(image).permute(2, 0, 1), (H, W)).cpu().numpy()

    @torch.inference_mode()
    def probs_sliding_batch(self, images: list[np.ndarray]) -> torch.Tensor:
        """n images (H, W, 3) uint8/float at any sizes -> (n, 640, 640, T) probs."""
        return self._probs_cm(images).permute(0, 2, 3, 1)

    @torch.inference_mode()
    def preds_sliding_batch(self, images: list[np.ndarray], out_hws: np.ndarray,
                            out_canvas: tuple[int, int], chunk: int = 32) -> torch.Tensor:
        """n images -> (n, Hmax, Wmax) int32 argmax maps at the per-image true
        sizes out_hws (n, 2); pixels beyond an image's size are 0."""
        probs = self._probs_cm(images)
        preds = torch.zeros((len(images), *out_canvas), dtype=torch.int32, device=self.device)
        for i, (h, w) in enumerate(np.asarray(out_hws, np.int64)):
            preds[i, :h, :w] = resize_argmax(probs[i], (int(h), int(w)), chunk)
        return preds
