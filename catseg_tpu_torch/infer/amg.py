"""Automatic mask generation (catseg_tpu/infer/amg.py; the vendored
SamAutomaticMaskGenerator, cat_seg/segment_anything/
automatic_mask_generator.py and its amg.py utilities).

A point grid prompts the SAM mask decoder, one foreground point a query,
three masks each; the masks are scored (predicted IoU, stability),
thresholded on the device, and only the survivors come to the host, where
box NMS drops duplicates and the records are RLE-encoded by the host
library (``evaluation.coco_dump.rle_encode``).  The image is encoded once;
the points decode in chunks of 64 queries.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.catseg import resolve_device
from ..core.sam import SAMVariant
from ..evaluation.coco_dump import rle_encode
from .sam_predictor import decode, sam_modules


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(n^2, 2) points in [0, 1]^2 (amg.py build_point_grid)."""
    offset = 1.0 / (2 * n_per_side)
    side = np.linspace(offset, 1.0 - offset, n_per_side)
    xs, ys = np.meshgrid(side, side)
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1).astype(np.float32)


def stability_score(mask_logits: torch.Tensor, mask_threshold: float = 0.0, offset: float = 1.0) -> torch.Tensor:
    """IoU between the mask thresholded at +-offset around the cutoff
    (amg.py calculate_stability_score)."""
    hi = (mask_logits > (mask_threshold + offset)).sum(dim=(-1, -2)).float()
    lo = (mask_logits > (mask_threshold - offset)).sum(dim=(-1, -2)).float()
    return hi / lo.clamp_min(1.0)


def _decode_point_grid(pe, dec, sam_feat: torch.Tensor, points_px: torch.Tensor, input_size: tuple[int, int],
                      chunk: int = 64):
    """Every grid point as a foreground click (plus the not-a-point pad
    slot), ``chunk`` queries a decoder call -> (masks (P, 3, 4 gh, 4 gw)
    logits, iou (P, 3), stability (P, 3))."""
    P = points_px.shape[0]
    pts = torch.cat([points_px[:, None], points_px.new_zeros(P, 1, 2)], dim=1)
    labels = torch.tensor([1, -1], device=points_px.device).expand(P, 2)
    sparse = pe.embed_points(pts, labels, input_size)
    masks, iou = zip(*(decode(pe, dec, sam_feat, sparse[s:s + chunk], None, True) for s in range(0, P, chunk)))
    masks = torch.cat(masks)
    return masks, torch.cat(iou), stability_score(masks)


def _boxes_from_masks(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) bool -> (N, 4) xyxy boxes."""
    boxes = np.zeros((len(masks), 4), np.float32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(ys):
            boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return boxes


def _nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float) -> list[int]:
    """Greedy box NMS in descending score order: kept indices."""
    order = np.argsort(-scores)
    keep = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        rest = order[1:]
        x1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        y1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        x2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        y2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        a = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        b = (boxes[rest, 2] - boxes[rest, 0]) * (boxes[rest, 3] - boxes[rest, 1])
        iou = inter / np.maximum(a + b - inter, 1e-9)
        order = rest[iou <= iou_thresh]
    return keep


class AutomaticMaskGenerator:
    def __init__(self, model_or_modules, variant: SAMVariant | None = None, points_per_side: int = 32,
                 pred_iou_thresh: float = 0.88, stability_score_thresh: float = 0.95, box_nms_thresh: float = 0.7,
                 min_mask_area: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.encoder, self.pe, self.dec = sam_modules(model_or_modules, self.device)
        self.variant = self.encoder.variant if variant is None else variant
        self.points_per_side = points_per_side
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.box_nms_thresh = box_nms_thresh
        self.min_mask_area = min_mask_area

    @torch.inference_mode()
    def generate(self, image_normalized: np.ndarray) -> list[dict]:
        """image: (H, W, 3) SAM-normalized, H = W = the variant's input size
        ideally.  Returns [{segmentation (RLE), bbox, predicted_iou,
        stability_score, point_coords}] by descending predicted IoU."""
        H, W = image_normalized.shape[:2]
        image = torch.as_tensor(np.asarray(image_normalized, np.float32))[None].to(self.device)
        feat = self.encoder(image, compute_dtype=torch.float32)
        points_px = build_point_grid(self.points_per_side) * np.asarray([W, H], np.float32)
        masks, iou, stab = _decode_point_grid(self.pe, self.dec, feat, torch.from_numpy(points_px).to(self.device),
                                             (H, W))
        masks, iou, stab = masks.flatten(0, 1), iou.flatten(), stab.flatten()
        keep = (iou > self.pred_iou_thresh) & (stab > self.stability_score_thresh)
        binary = (masks[keep] > 0.0).cpu().numpy()
        keep = keep.cpu().numpy()
        iou, stab = iou.cpu().numpy()[keep], stab.cpu().numpy()[keep]
        pts = np.repeat(points_px, 3, axis=0)[keep]
        if self.min_mask_area:
            sel = binary.sum(axis=(1, 2)) >= self.min_mask_area
            binary, iou, stab, pts = binary[sel], iou[sel], stab[sel], pts[sel]
        if len(binary) == 0:
            return []
        boxes = _boxes_from_masks(binary)
        records = [{"segmentation": rle_encode(binary[i]), "bbox": boxes[i].tolist(),
                    "predicted_iou": float(iou[i]), "stability_score": float(stab[i]),
                    "point_coords": pts[i].tolist()}
                   for i in _nms(boxes, iou, self.box_nms_thresh)]
        records.sort(key=lambda r: -r["predicted_iou"])
        return records
