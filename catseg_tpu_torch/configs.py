"""Configurations and class lists of the port (catseg_tpu/configs.py).

catseg_tpu's config dataclasses and presets are host code with no JAX in
them, so the port uses them as they are, through this one module.  The
benchmarks' class lists are read straight from the JSON files catseg_tpu
ships (catseg_tpu.data imports PIL, which the GPU machine does not have).
"""

from __future__ import annotations

import json
from pathlib import Path

import catseg_tpu
from catseg_tpu.configs import (CLIP_PIXEL_MEAN, CLIP_PIXEL_STD, CATSegConfig, CLIPVariant, eval_preset,
                                vitb384)

__all__ = ["CLIP_PIXEL_MEAN", "CLIP_PIXEL_STD", "CATSegConfig", "CLIPVariant", "class_names",
           "eval_preset", "vitb384"]

_CLASS_JSONS = Path(catseg_tpu.__file__).resolve().parent / "data" / "class_jsons"


def class_names(benchmark: str) -> list[str]:
    """The class names of a benchmark, e.g. ``class_names("ade150")`` (150 names)."""
    return json.loads((_CLASS_JSONS / f"{benchmark}.json").read_text())
