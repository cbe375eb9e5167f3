"""COCO-format prediction dump, sem_seg_predictions.json
(catseg_tpu/evaluation/coco_dump.py).

Mirrors the reference evaluators' side output (SemSegEvaluator /
SemSegGzeroEvaluator, plain_train_net.py:148-228): for each image, one
record per predicted category with an uncompressed COCO RLE of its binary
mask, encoded by ``csrc/host/rle.cpp`` in the host library.
"""

from __future__ import annotations

import json

import numpy as np

from ..data.catalogs import idmap_path
from ..data.image_io import host_library


def rle_encode(mask: np.ndarray) -> dict:
    """Binary (H, W) mask -> COCO uncompressed RLE dict (column-major runs,
    starting with the count of zeros)."""
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    h, w = mask.shape
    counts = np.zeros(h * w + 1, dtype=np.uint32)
    n = host_library().rle_encode(mask.ctypes.data, h, w, counts.ctypes.data)
    return {"size": [h, w], "counts": counts[:n].tolist()}


def rle_decode(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    counts = np.ascontiguousarray(rle["counts"], dtype=np.uint32)
    mask = np.zeros((h, w), dtype=np.uint8)
    host_library().rle_decode(counts.ctypes.data, len(counts), h, w, mask.ctypes.data)
    return mask


def predictions_to_coco(pred: np.ndarray, file_name: str, id_map: dict[int, int] | None = None) -> list[dict]:
    """(H, W) argmax map -> one RLE record per predicted category.

    ``id_map`` maps contiguous train ids back to dataset category ids (the
    inverse of stuff_dataset_id_to_contiguous_id), as the reference
    evaluator does before dumping (plain_train_net.py:210-216)."""
    out = []
    for cat in np.unique(pred):
        out.append({
            "file_name": file_name,
            "category_id": int(id_map[int(cat)]) if id_map else int(cat),
            "segmentation": rle_encode(pred == cat),
        })
    return out


def dataset_id_map(spec) -> dict[int, int] | None:
    """contiguous -> dataset-id map for a DatasetSpec (None = identity)."""
    if spec.idmap_json is None:
        return None
    with open(idmap_path(spec.idmap_json)) as f:
        fwd = json.load(f)  # dataset_id (str) -> contiguous
    return {int(v): int(k) for k, v in fwd.items()}


class PredictionDumper:
    def __init__(self, path: str, id_map: dict[int, int] | None = None):
        self.path = path
        self.id_map = id_map
        self.records: list[dict] = []

    def add(self, pred: np.ndarray, file_name: str) -> None:
        self.records.extend(predictions_to_coco(pred, file_name, self.id_map))

    def write(self) -> None:
        with open(self.path, "w") as f:
            json.dump(self.records, f)
