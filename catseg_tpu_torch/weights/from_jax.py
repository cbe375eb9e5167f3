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
from .convert import CLIP_PREFIX, PROMPTS
from .export import export_catseg_checkpoint


def state_dict_from_params(params: dict) -> dict[str, torch.Tensor]:
    """JAX CATSeg parameter pytree (arrays or numpy) -> torch state dict."""
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in export_catseg_checkpoint(params).items()}


def load_state_dict_(model: CATSeg, sd: dict[str, torch.Tensor], prefix: str = "") -> CATSeg:
    """Load the released-named ``sd`` into ``model`` strictly: into the
    submodule at ``prefix`` (e.g. the CLIP's) where one is given.  VPT
    prompts in ``sd`` give the model prompts of their shape first."""
    prompts = sd.get(CLIP_PREFIX + PROMPTS)
    if prompts is not None and model.clip.visual.prompt_tokens is None:
        model.clip.visual.add_prompt_tokens(*prompts.shape[:2])
    module = model.get_submodule(prefix.rstrip(".")) if prefix else model
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return model


def load_params_(model: CATSeg, params: dict) -> CATSeg:
    """Copy a JAX CATSeg pytree into ``model`` (strict: every key must match),
    VPT prompts included."""
    return load_state_dict_(model, state_dict_from_params(params))
