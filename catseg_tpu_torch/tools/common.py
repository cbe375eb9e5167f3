"""Shared CLI plumbing (catseg_tpu/tools/common.py): config resolution,
KEY=VALUE overrides, the device switch and weights."""

from __future__ import annotations

import ast

from .. import configs
from ..configs import CATSegConfig


PRESETS = {
    "vitb384": configs.vitb384,
    "vitl336": configs.vitl336,
    "vith336": configs.vith336,
    "vitg336": configs.vitg336,
    "fusion_ver31": configs.fusion_ver31,
    "fusion_ver14": configs.fusion_ver14,
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


def load_params(path: str | None, cfg: CATSegConfig, seed: int = 0, device="cuda"):
    """A CATSeg (or ``cfg``'s fusion model) on ``device`` in eval mode, as
    catseg_tpu's ``load_params`` builds its pytree: seeded random weights
    (no path); a catseg_tpu pytree (``.npz``); or a torch file (``.pth`` /
    ``.pt`` / ``.bin``, ``weights.convert.load_torch_checkpoint``).  A torch file with no
    ``sem_seg_head.`` key is a bare OpenAI or open_clip CLIP: the reference's
    train-time init, ``build_catseg(cfg, seed=seed)`` with that CLIP in place
    (its positional grid resized to ``cfg.clip.pretrain_grid``).  Any other
    goes through the released-checkpoint converter, which also reads the
    port's own ``tools.train`` checkpoints and the fork's fusion checkpoints."""
    from ..core.catseg import build_catseg, model_class, resolve_device

    if path is None:
        return build_catseg(cfg, seed=seed, device=device)
    if path.endswith(".npz"):
        from ..weights.io import load_pytree

        return build_catseg(cfg, params=load_pytree(path), device=device)
    if not path.endswith((".pth", ".pt", ".bin")):
        raise SystemExit(f"unknown checkpoint format {path!r}: .npz (catseg_tpu pytree) or .pth / .pt / .bin")
    from ..weights import convert
    from ..weights.from_jax import load_state_dict_

    device = resolve_device(device)
    sd = convert.load_torch_checkpoint(path)
    if not any(k.startswith("sem_seg_head.") for k in sd):
        model = build_catseg(cfg, seed=seed, device="cpu")
        clip_sd = convert.convert_openclip_state_dict(sd, cfg.clip.pretrain_grid)
        load_state_dict_(model, {convert.CLIP_PREFIX + k: v for k, v in clip_sd.items()}, prefix=convert.CLIP_PREFIX)
    else:
        sd = convert.convert_catseg_checkpoint(sd, num_layers=cfg.num_layers)
        model = load_state_dict_(model_class(cfg)(cfg), sd)
    return model.to(device).eval()


def add_device_arg(ap):
    """--device cuda|cpu: where the model runs (default the card)."""
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="run on the GPU (default) or the CPU's plain PyTorch path")
