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


def vss_block_state_dict(p: dict) -> dict[str, torch.Tensor]:
    """catseg_tpu's VSSBlock pytree (``core.mamba.init_vss_block``) -> the
    state dict of the port's ``core.mamba.VSSBlock`` (MambaIR's names):
    (in, out) matrices transposed, HWIO convs to OIHW, the per-direction
    A_log (4, D, N) and D (4, D) flattened to MambaIR's (4 D, N) / (4 D)."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32))

    def oihw(w):
        return t(np.transpose(np.asarray(w), (3, 2, 0, 1)))

    s = p["ss2d"]
    sd = {
        "ln_1.weight": t(p["ln_1"]["g"]), "ln_1.bias": t(p["ln_1"]["b"]),
        "skip_scale": t(p["skip_scale"]), "skip_scale2": t(p["skip_scale2"]),
        "ln_2.weight": t(p["ln_2"]["g"]), "ln_2.bias": t(p["ln_2"]["b"]),
        "self_attention.in_proj.weight": t(s["in_proj_w"]).t().contiguous(),
        "self_attention.conv2d.weight": oihw(s["conv_w"]),
        "self_attention.conv2d.bias": t(s["conv_b"]),
        "self_attention.x_proj_weight": t(s["x_proj_w"]),
        "self_attention.dt_projs_weight": t(s["dt_proj_w"]),
        "self_attention.dt_projs_bias": t(s["dt_proj_b"]),
        "self_attention.A_logs": t(s["A_log"]).reshape(-1, np.asarray(s["A_log"]).shape[-1]),
        "self_attention.Ds": t(s["D"]).reshape(-1),
        "self_attention.out_norm.weight": t(s["out_norm"]["g"]),
        "self_attention.out_norm.bias": t(s["out_norm"]["b"]),
        "self_attention.out_proj.weight": t(s["out_proj_w"]).t().contiguous(),
        "conv_blk.cab.0.weight": oihw(p["cab_conv1_w"]), "conv_blk.cab.0.bias": t(p["cab_conv1_b"]),
        "conv_blk.cab.2.weight": oihw(p["cab_conv2_w"]), "conv_blk.cab.2.bias": t(p["cab_conv2_b"]),
        "conv_blk.cab.3.attention.1.weight": t(p["ca_fc1_w"]).t()[..., None, None].contiguous(),
        "conv_blk.cab.3.attention.1.bias": t(p["ca_fc1_b"]),
        "conv_blk.cab.3.attention.3.weight": t(p["ca_fc2_w"]).t()[..., None, None].contiguous(),
        "conv_blk.cab.3.attention.3.bias": t(p["ca_fc2_b"]),
    }
    return sd
