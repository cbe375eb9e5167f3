"""catseg_tpu parameters -> the port's modules.

``export.export_catseg_checkpoint`` (pure numpy, the port's copy of
catseg_tpu's exporter) turns a JAX parameter pytree into the released
checkpoints' torch state dict; the port's attribute names are those keys, so
loading needs no renaming table.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.catseg import CATSeg
from .export import export_catseg_checkpoint


def state_dict_from_params(params: dict) -> dict[str, torch.Tensor]:
    """JAX CATSeg parameter pytree (arrays or numpy) -> torch state dict."""
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in export_catseg_checkpoint(params).items()}


def load_params_(model: CATSeg, params: dict) -> CATSeg:
    """Copy a JAX CATSeg pytree into ``model`` (strict: every key must match).
    A pytree with VPT prompts (``clip.visual.prompt_tokens``) gives the
    model prompts of their shape first."""
    sd = state_dict_from_params(params)
    prompts = sd.get("sem_seg_head.predictor.clip_model.visual.transformer.prompt_tokens")
    if prompts is not None and model.clip.visual.prompt_tokens is None:
        model.clip.visual.add_prompt_tokens(*prompts.shape[:2])
    model.load_state_dict(sd, strict=True)
    return model
