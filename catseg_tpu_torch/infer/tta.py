"""Test-time augmentation: multi-scale + horizontal-flip probability
averaging (catseg_tpu/infer/tta.py).

Mirrors the reference SemanticSegmentorWithTTA
(cat_seg/test_time_augmentation.py:19-120), whose DatasetMapperTTA (the
released configs never override TEST.AUG) gives detectron2's defaults:
ResizeShortestEdge at MIN_SIZES (400..1200, 9 scales, MAX_SIZE 4000) x
{identity, hflip} = 18 augmented copies of the ORIGINAL image, each through
the full model, probabilities averaged.

The averaging happens in the model's output space (640^2 sliding, 96^2
whole image): each copy's postprocess resize is the same linear map, so
mean-then-resize equals resize-then-mean.  On the sliding branch each
scale's {image, hflip} pair goes through one ``probs_sliding_batch`` call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.loader import resize_shortest_edge
from .pipeline import Predictor

# detectron2 TEST.AUG defaults (defaults.py): the reference's effective TTA set
D2_TTA_MIN_SIZES = (400, 500, 600, 700, 800, 900, 1000, 1100, 1200)
D2_TTA_MAX_SIZE = 4000


def _hflip(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[:, ::-1])


class TTAPredictor:
    """min_sizes=None degenerates to single-scale {identity, hflip}
    averaging (the input is then used as it is, assumed already resized)."""

    def __init__(self, predictor: Predictor, min_sizes: tuple[int, ...] | None = D2_TTA_MIN_SIZES,
                 max_size: int = D2_TTA_MAX_SIZE, flip: bool = True):
        self.predictor = predictor
        self.cfg = predictor.cfg
        self.min_sizes = min_sizes
        self.max_size = max_size
        self.flip = flip

    def _scaled(self, image: np.ndarray):
        if not self.min_sizes:
            yield image
            return
        for s in self.min_sizes:
            yield resize_shortest_edge(image, s, self.max_size)

    def _pair_probs_sliding(self, img: np.ndarray) -> torch.Tensor:
        if not self.flip:
            return self.predictor.probs_sliding(img)
        p2 = self.predictor.probs_sliding_batch([img, _hflip(img)])
        return (p2[0] + p2[1].flip(1)) / 2.0

    def probs_sliding(self, image: np.ndarray) -> torch.Tensor:
        acc = None
        n = 0
        for img_s in self._scaled(image):
            ps = self._pair_probs_sliding(img_s)
            acc = ps if acc is None else acc + ps
            n += 1
        return acc / n

    def probs(self, image: np.ndarray) -> torch.Tensor:
        """Branch-agnostic TTA-averaged probabilities (the eval harness's
        entry).  With min_sizes set, ``image`` must be the ORIGINAL image:
        the scales are applied here, as DatasetMapperTTA does."""
        if self.cfg.sliding_window:
            return self.probs_sliding(image)
        acc = None
        n = 0
        for img_s in self._scaled(image):
            p = self.predictor.probs(img_s)
            if self.flip:
                p = (p + self.predictor.probs(_hflip(img_s)).flip(1)) / 2.0
            acc = p if acc is None else acc + p
            n += 1
        return acc / n

    def predict(self, image: np.ndarray, out_hw=None) -> dict:
        out_hw = out_hw or image.shape[:2]
        acc = None
        n = 0
        for img_s in self._scaled(image):
            p = self.predictor.predict(img_s, out_hw)["sem_seg"]
            if self.flip:
                p = (p + self.predictor.predict(_hflip(img_s), out_hw)["sem_seg"][:, :, ::-1]) / 2.0
            acc = p if acc is None else acc + p
            n += 1
        return {"sem_seg": acc / n}
