"""Sliding-window inference (catseg_tpu/infer/pipeline.py).

Per image: bilinear resize of the true-size image to sw_out_res (640) and
sw_kernel (384) -> 4 tiles (kernel 384, stride 256) + 1 global tile -> one
model forward for all tiles of the batch -> per tile 96 -> 384 bilinear
logits, sigmoid, fold with the overlap divisor -> average with the global
tile upsampled to 640 -> bilinear resize to the true size and argmax over
classes in chunks with a strict ``>`` running max.

bf16 compute carries the probabilities in bf16 as the reference does
(sigmoid and the resize arithmetic stay fp32); fp32 compute keeps an fp32
tail.  The reference's static-canvas machinery exists for XLA's static
shapes and is not needed here: every image is resized at its own size.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import CATSegConfig
from ..core.catseg import CATSeg, compute_dtype, resolve_device
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
    logits = model(batch, text_feats)                        # ((nt+1)*n, T, 96, 96) fp32
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
    """Sliding-window prediction for a list of true-size RGB images.

    The model and the text features move to ``device``, the card unless the
    caller asks for the CPU; without a card the default raises."""

    def __init__(self, model: CATSeg, cfg: CATSegConfig, class_names: list[str],
                 text_feats: torch.Tensor | np.ndarray | None = None, device="cuda"):
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
            t = torch.as_tensor(np.ascontiguousarray(im), device=self.device).float()[None]
            big.append(resize_bilinear(t, (out, out)))
            small.append(resize_bilinear(t, (k, k)))
        return torch.cat(big), torch.cat(small)

    def _probs_cm(self, images: list[np.ndarray]) -> torch.Tensor:
        img640s, imgks = self._inputs(images)
        return sliding_window_probs_batch(self.model, img640s, imgks, self.text_feats, self.cfg)

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
