"""Shared CLI plumbing (catseg_tpu/tools/common.py): config resolution,
KEY=VALUE overrides, the device switch and weights."""

from __future__ import annotations

import ast

from .. import configs
from ..configs import CATSegConfig


def _fusion(name: str):
    def preset(**kw):
        raise NotImplementedError(f"the {name} preset (dual-encoder fusion) is not ported yet (ROADMAP A8)")
    return preset


PRESETS = {
    "vitb384": configs.vitb384,
    "vitl336": configs.vitl336,
    "vith336": configs.vith336,
    "vitg336": configs.vitg336,
    "fusion_ver31": _fusion("fusion_ver31"),
    "fusion_ver14": _fusion("fusion_ver14"),
}


def resolve_config(name: str, overrides: list[str]) -> CATSegConfig:
    """Preset name + KEY=VALUE overrides (values parsed as python literals)."""
    if name not in PRESETS:
        raise SystemExit(f"unknown config preset {name!r}; available: {sorted(PRESETS)}")
    cfg = PRESETS[name]()
    kw = {}
    for ov in overrides:
        key, _, value = ov.partition("=")
        try:
            kw[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            kw[key] = value
    return cfg.replace(**kw) if kw else cfg


_PROMPTS = "sem_seg_head.predictor.clip_model.visual.transformer.prompt_tokens"


def load_params(path: str | None, cfg: CATSegConfig, seed: int = 0, device="cuda"):
    """A CATSeg on ``device`` in eval mode: seeded random weights (no path),
    a catseg_tpu pytree (``.npz``), or a ``.pth`` / ``.pt`` whose keys are
    exactly the port's ``state_dict`` keys (bare, or ``{"model": sd}`` as
    ``tools.train`` saves it)."""
    import torch

    from ..core.catseg import CATSeg, build_catseg, resolve_device

    if path is None:
        return build_catseg(cfg, seed=seed, device=device)
    if path.endswith(".npz"):
        from ..weights.io import load_pytree

        return build_catseg(cfg, params=load_pytree(path), device=device)
    if path.endswith((".pth", ".pt")):
        device = resolve_device(device)
        blob = torch.load(path, map_location="cpu", weights_only=True)
        sd = blob.get("model", blob) if isinstance(blob, dict) else blob
        model = CATSeg(cfg)
        prompts = sd.get(_PROMPTS) if isinstance(sd, dict) else None
        if prompts is not None:
            model.clip.visual.add_prompt_tokens(*prompts.shape[:2])
        if not isinstance(sd, dict) or set(sd) != set(model.state_dict()):
            raise NotImplementedError(
                f"{path}: only checkpoints with exactly the port's state_dict keys load; converting the released "
                "checkpoints (fused in_proj), OpenCLIP or bare CLIP weights is not ported yet (ROADMAP A5)")
        model.load_state_dict(sd, strict=True)
        return model.to(device).eval()
    raise SystemExit(f"unknown checkpoint format {path!r}: .npz (catseg_tpu pytree) or .pth / .pt")


def add_device_arg(ap):
    """--device cuda|cpu: where the model runs (default the card)."""
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the GPU (default) or the CPU's plain PyTorch path")
