"""Torch checkpoints -> the port's ``state_dict`` (catseg_tpu/weights/convert.py).

The port's attribute names are the released checkpoints' keys
(``weights/export.py``), so conversion selects, casts to fp32 and renames
nothing but the CLIP attention: a fused ``attn.in_proj_weight`` (OpenAI and
open_clip files) is cut into the split ``q/k/v_proj_weight`` the port's
``Attention`` holds.  Sources:

- OpenAI CLIP state dicts, fused or split qkv, with VPT ``prompt_tokens``
  (:func:`convert_clip_state_dict`);
- open_clip state dicts (ViT-H-14 / ViT-bigG-14): the ``attn_mask`` and
  ``logit_bias`` buffers dropped and the visual positional embedding's grid
  resized bicubically in float64 (:func:`convert_openclip_state_dict`);
- released CAT-Seg checkpoints (``model_base.pth`` / ``model_large.pth``,
  ``{"model": sd}`` or bare ``sd``; :func:`convert_catseg_checkpoint`).

Keys a source holds beyond these are ignored, as catseg_tpu's converter
ignores them; a missing one raises KeyError.  :func:`load_torch_checkpoint`
reads a pickle with ``weights_only=True`` or an OpenAI zoo TorchScript
archive.
"""

from __future__ import annotations

import zipfile

import numpy as np
import torch

CLIP_PREFIX = "sem_seg_head.predictor.clip_model."
AGG_PREFIX = "sem_seg_head.predictor.transformer."
PROMPTS = "visual.transformer.prompt_tokens"

_CLIP_KEYS = ("visual.conv1.weight", "visual.class_embedding", "visual.positional_embedding",
              "visual.ln_pre.weight", "visual.ln_pre.bias", "visual.ln_post.weight", "visual.ln_post.bias",
              "visual.proj", "token_embedding.weight", "positional_embedding", "ln_final.weight", "ln_final.bias",
              "text_projection")
_CLIP_BLOCK = ("attn.in_proj_bias", "attn.out_proj.weight", "attn.out_proj.bias", "ln_1.weight", "ln_1.bias",
               "ln_2.weight", "ln_2.bias", "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight",
               "mlp.c_proj.bias")
_NORM = ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias")
_SWIN = _NORM + tuple(f"{m}.{p}" for m in ("attn.q", "attn.k", "attn.v", "attn.proj", "mlp.fc1", "mlp.fc2")
                      for p in ("weight", "bias"))
_CLASS = _NORM + tuple(f"{m}.{p}" for m in ("attention.q", "attention.k", "attention.v", "MLP.0", "MLP.2")
                       for p in ("weight", "bias"))
_UP = ("up.weight", "up.bias", "conv.double_conv.0.weight", "conv.double_conv.1.weight",
       "conv.double_conv.1.bias", "conv.double_conv.3.weight", "conv.double_conv.4.weight",
       "conv.double_conv.4.bias")


def _f32(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(torch.float32) for k, v in sd.items()}


def _count_layers(sd: dict, stem: str) -> int:
    probe = f"{stem}."
    return 1 + max((int(k[len(probe):].split(".")[0]) for k in sd if k.startswith(probe)), default=-1)


def _copy(sd: dict, out: dict, prefix: str, names) -> None:
    for name in names:
        out[prefix + name] = sd[prefix + name]


def _clip_block(sd: dict, out: dict, prefix: str) -> None:
    fused = sd.get(prefix + "attn.in_proj_weight")
    if fused is not None:
        d = fused.shape[0] // 3
        qkv = fused[:d], fused[d:2 * d], fused[2 * d:]
    else:
        qkv = tuple(sd[f"{prefix}attn.{n}_proj_weight"] for n in "qkv")
    for n, w in zip("qkv", qkv):
        out[f"{prefix}attn.{n}_proj_weight"] = w
    _copy(sd, out, prefix, _CLIP_BLOCK)


def convert_clip_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """OpenAI-CLIP-named state dict (no prefix; tensors or numpy, fused or
    split qkv) -> the port's ``CLIP`` state dict, fp32.  A missing
    ``logit_scale`` becomes 0, as catseg_tpu's converter makes it."""
    sd = _f32(sd)
    out = {}
    _copy(sd, out, "", _CLIP_KEYS)
    out["logit_scale"] = sd.get("logit_scale", torch.tensor(0.0))
    if PROMPTS in sd:   # VPT (model_vpt.py:252)
        out[PROMPTS] = sd[PROMPTS]
    for stem in ("visual.transformer.resblocks", "transformer.resblocks"):
        for i in range(_count_layers(sd, stem)):
            _clip_block(sd, out, f"{stem}.{i}.")
    return out


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """torch's cubic convolution kernel (Keys, a = -0.75)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0
    outer = a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a
    return np.where(ax <= 1.0, inner, np.where(ax < 2.0, outer, 0.0))


def _cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float64 bicubic matrix, align_corners=False: four
    Keys taps at the fp32 source coordinate, indices clamped to the edge."""
    i = np.arange(out_size, dtype=np.float32)
    x = (i + np.float32(0.5)) * (np.float32(in_size) / np.float32(out_size)) - np.float32(0.5)
    x0 = np.floor(x).astype(np.int64)
    f = (x - x0.astype(np.float32)).astype(np.float64)
    w = np.zeros((out_size, in_size))
    rows = np.arange(out_size)
    for t in range(-1, 3):
        np.add.at(w, (rows, np.clip(x0 + t, 0, in_size - 1)), _cubic_kernel(f - t))
    return w


def resize_pos_embed_grid(pe: np.ndarray, target_grid: int) -> np.ndarray:
    """open_clip's ``resize_pos_embed`` at conversion time: the grid part of
    a (1 + S^2, W) positional embedding resized bicubically to
    ``target_grid``^2 (align_corners=False; antialias does nothing when
    upscaling), in float64, rounded back to ``pe``'s dtype.  The published
    laion2b ViT-H/G files ship a 16x16 grid; the reference runs them at 336^2
    (``force_image_size=336``, cat_seg_predictor.py:64-76), grid 24."""
    pe = np.asarray(pe)
    n_extra = pe.shape[0] - int(round((pe.shape[0] - 1) ** 0.5)) ** 2
    grid = int(round((pe.shape[0] - n_extra) ** 0.5))
    if grid == target_grid:
        return pe
    tok, img = pe[:n_extra], pe[n_extra:]
    img = img.reshape(grid, grid, -1).astype(np.float64)
    w = _cubic_weights(grid, target_grid)
    img = np.einsum("hwc,oh->owc", img, w)
    img = np.einsum("hwc,ow->hoc", img, w)
    return np.ascontiguousarray(np.concatenate([tok, img.reshape(target_grid * target_grid, -1).astype(pe.dtype)]))


def convert_openclip_state_dict(sd: dict, target_grid: int | None = None) -> dict[str, torch.Tensor]:
    """open_clip CLIP state dict (OpenAI key names, fused qkv, plus the
    ``attn_mask`` / ``logit_bias`` buffers, which are dropped) -> the port's
    ``CLIP`` state dict, the visual positional embedding's grid resized to
    ``target_grid`` (:func:`resize_pos_embed_grid`)."""
    sd = {k: v for k, v in sd.items() if not (k.endswith("attn_mask") or k == "logit_bias")}
    out = convert_clip_state_dict(sd)
    if target_grid is not None:
        pe = out["visual.positional_embedding"].numpy()
        out["visual.positional_embedding"] = torch.from_numpy(resize_pos_embed_grid(pe, target_grid))
    return out


def convert_aggregator_state_dict(sd: dict, num_layers: int | None = None) -> dict[str, torch.Tensor]:
    """Unprefixed Aggregator state dict (model.py:558; the swin ``attn_mask``
    buffers may be there) -> the port's ``Aggregator`` state dict.
    ``num_layers`` defaults to the count in the checkpoint; an explicit
    count that disagrees raises ValueError (the fork's base config trains 4
    layers: reading 2 of them would give a wrong model without an error)."""
    sd = _f32(sd)
    in_ckpt = _count_layers(sd, "layers")
    if num_layers is None:
        num_layers = in_ckpt
    elif in_ckpt and num_layers != in_ckpt:
        raise ValueError(f"checkpoint has {in_ckpt} aggregator layers, num_layers={num_layers}")
    out = {}
    _copy(sd, out, "", ("conv1.weight", "conv1.bias", "head.weight", "head.bias"))
    for name in ("decoder1.", "decoder2."):
        _copy(sd, out, name, _UP)
    for proj in ("guidance_projection.0.", "text_guidance_projection.0."):
        if proj + "weight" in sd:
            _copy(sd, out, proj, ("weight", "bias"))
    if "decoder_guidance_projection.0.0.weight" in sd:
        for i in range(2):
            _copy(sd, out, f"decoder_guidance_projection.{i}.0.", ("weight", "bias"))
    for i in range(num_layers):
        _copy(sd, out, f"layers.{i}.swin_block.block_1.", _SWIN)
        _copy(sd, out, f"layers.{i}.swin_block.block_2.", _SWIN)
        _copy(sd, out, f"layers.{i}.swin_block.guidance_norm.", ("weight", "bias"))
        _copy(sd, out, f"layers.{i}.attention.", _CLASS)
        for pad in ("padding_tokens", "padding_guidance"):   # (1, 1, C) in the reference (model.py:372)
            key = f"layers.{i}.attention.{pad}"
            if key in sd:
                out[key] = sd[key].reshape(1, 1, -1)
    return out


def convert_catseg_checkpoint(sd: dict, num_layers: int | None = None) -> dict[str, torch.Tensor]:
    """A released CAT-Seg state dict (detectron2 names:
    ``sem_seg_head.predictor.{clip_model,transformer}.*``, ``upsample{1,2}.*``)
    -> the port's ``CATSeg`` state dict.  The fork's fusion checkpoints
    (Ver31 ``fusion_corr`` / ``dino_model.``, Ver14 ``sam_encoder.``) raise
    NotImplementedError: those model families are not ported."""
    agg = {k[len(AGG_PREFIX):]: v for k, v in sd.items()
           if k.startswith(AGG_PREFIX) and not k.endswith("attn_mask")}
    if "fusion_corr.weight" in agg or any(k.startswith(("dino_model.", "sam_encoder.")) for k in sd):
        raise NotImplementedError("a fusion (Ver31 DINO / Ver14 SAM) checkpoint: the fork's fusion families are "
                                  "not ported yet (ROADMAP A8)")
    out = {CLIP_PREFIX + k: v for k, v in
           convert_clip_state_dict({k[len(CLIP_PREFIX):]: v for k, v in sd.items()
                                    if k.startswith(CLIP_PREFIX)}).items()}
    out.update({AGG_PREFIX + k: v for k, v in convert_aggregator_state_dict(agg, num_layers).items()})
    out.update(_f32({f"upsample{i}.{p}": sd[f"upsample{i}.{p}"] for i in (1, 2) for p in ("weight", "bias")}))
    return out


def _is_torchscript(path: str) -> bool:
    """A TorchScript archive is a zip holding ``<archive>/constants.pkl``."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as zf:
        return any(n.split("/", 1)[-1] == "constants.pkl" for n in zf.namelist())


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """A ``.pth`` / ``.pt`` / ``.bin`` file -> its flat state dict on the CPU
    (``{"model": sd}`` unwrapped).  An OpenAI zoo TorchScript archive
    (ViT-B-16.pt, ...) is read by ``torch.jit.load(...).state_dict()``, as
    the reference reads it (third_party/clip.py:70-84); anything else by
    ``torch.load(weights_only=True)``, which refuses a pickle holding objects
    other than tensors, containers and plain values."""
    if _is_torchscript(path):
        obj = torch.jit.load(path, map_location="cpu").state_dict()
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state dict, got {type(obj).__name__}")
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}
