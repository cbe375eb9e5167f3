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
  ``{"model": sd}`` or bare ``sd``; :func:`convert_catseg_checkpoint`), and
  the fork's fusion checkpoints: Ver31 (FusionAggregatorVer31 names under
  ``sem_seg_head.predictor.transformer.``, ``dino_model.``,
  ``dino_down_sample``, ``dino_decod_proj{1,2}``) and Ver14 (``sam_encoder.``,
  ``sam_prompt_encoder.``, ``sam_decoder.``, Meta SAM's names; the SAM depth
  read from the block count).

Keys a source holds beyond these are ignored, as catseg_tpu's converter
ignores them; a missing one raises KeyError.  :func:`load_torch_checkpoint`
reads a pickle with ``weights_only=True`` or an OpenAI zoo TorchScript
archive.
"""

from __future__ import annotations

import zipfile

import numpy as np
import torch

from ..ops import cubic_weights

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
_WB = ("weight", "bias")
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
    w = cubic_weights(grid, target_grid)
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


def _agg_layers(sd: dict, out: dict, num_layers: int | None) -> None:
    """The aggregator's projections and layers: ``num_layers`` defaults to
    the count in the checkpoint; an explicit count that disagrees raises
    ValueError (the fork's base config trains 4 layers: reading 2 of them
    would give a wrong model without an error)."""
    in_ckpt = _count_layers(sd, "layers")
    if num_layers is None:
        num_layers = in_ckpt
    elif in_ckpt and num_layers != in_ckpt:
        raise ValueError(f"checkpoint has {in_ckpt} aggregator layers, num_layers={num_layers}")
    for proj in ("guidance_projection.0.", "text_guidance_projection.0."):
        if proj + "weight" in sd:
            _copy(sd, out, proj, ("weight", "bias"))
    for i in range(num_layers):
        _copy(sd, out, f"layers.{i}.swin_block.block_1.", _SWIN)
        _copy(sd, out, f"layers.{i}.swin_block.block_2.", _SWIN)
        _copy(sd, out, f"layers.{i}.swin_block.guidance_norm.", ("weight", "bias"))
        _copy(sd, out, f"layers.{i}.attention.", _CLASS)
        for pad in ("padding_tokens", "padding_guidance"):   # (1, 1, C) in the reference (model.py:372)
            key = f"layers.{i}.attention.{pad}"
            if key in sd:
                out[key] = sd[key].reshape(1, 1, -1)


def convert_aggregator_state_dict(sd: dict, num_layers: int | None = None) -> dict[str, torch.Tensor]:
    """Unprefixed Aggregator state dict (model.py:558; the swin ``attn_mask``
    buffers may be there) -> the port's ``Aggregator`` state dict."""
    sd = _f32(sd)
    out = {}
    _copy(sd, out, "", ("conv1.weight", "conv1.bias", "head.weight", "head.bias"))
    for name in ("decoder1.", "decoder2."):
        _copy(sd, out, name, _UP)
    if "decoder_guidance_projection.0.0.weight" in sd:
        for i in range(2):
            _copy(sd, out, f"decoder_guidance_projection.{i}.0.", ("weight", "bias"))
    _agg_layers(sd, out, num_layers)
    return out


def convert_fusion_aggregator_state_dict(sd: dict, num_layers: int | None = None) -> dict[str, torch.Tensor]:
    """Unprefixed FusionAggregatorVer31 state dict -> the port's
    ``FusionAggregator`` state dict."""
    sd = _f32(sd)
    out = {}
    _copy(sd, out, "", tuple(f"{m}.{p}" for m in ("conv1", "conv2", "fusion_corr", "head") for p in _WB))
    for name in ("Fusiondecoder1.", "Fusiondecoder2."):
        _copy(sd, out, name, _UP)
    for name in ("CLIP", "DINO"):
        for i in range(2):
            _copy(sd, out, f"{name}_decoder_guidance_projection.{i}.0.", ("weight", "bias"))
    _agg_layers(sd, out, num_layers)
    return out


def convert_dino_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """facebookresearch/dino ViT state dict -> the port's ``DINO``; the CLS
    token and positional embedding reshaped to (1, 1, C) and (1, N, C)."""
    sd = _f32(sd)
    out = {}
    _copy(sd, out, "patch_embed.proj.", _WB)
    _copy(sd, out, "norm.", _WB)
    C = sd["cls_token"].shape[-1]
    out["cls_token"] = sd["cls_token"].reshape(1, 1, C)
    out["pos_embed"] = sd["pos_embed"].reshape(1, -1, C)
    for i in range(_count_layers(sd, "blocks")):
        for m in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            _copy(sd, out, f"blocks.{i}.{m}.", _WB)
    return out


def convert_sam_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """Meta SAM image-encoder state dict (no prefix) -> the port's
    ``SAMEncoder``; as many blocks as the checkpoint holds."""
    sd = _f32(sd)
    out = {"pos_embed": sd["pos_embed"], "neck.0.weight": sd["neck.0.weight"], "neck.2.weight": sd["neck.2.weight"]}
    for m in ("patch_embed.proj.", "neck.1.", "neck.3."):
        _copy(sd, out, m, _WB)
    for i in range(_count_layers(sd, "blocks")):
        p = f"blocks.{i}."
        for m in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.lin1", "mlp.lin2"):
            _copy(sd, out, f"{p}{m}.", _WB)
        _copy(sd, out, p, ("attn.rel_pos_h", "attn.rel_pos_w"))
    return out


def convert_sam_prompt_decoder(pe: dict, dec: dict) -> dict[str, torch.Tensor]:
    """Meta SAM prompt-encoder and mask-decoder state dicts (no prefix) ->
    the port's ``sam_prompt_encoder.`` / ``sam_decoder.`` keys: four point
    embeddings; the decoder's layers, hypernetwork MLPs (one per mask token,
    three layers each) and IoU head as the checkpoint holds them."""
    pe, dec = _f32(pe), _f32(dec)
    out = {"sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix":
           pe["pe_layer.positional_encoding_gaussian_matrix"]}
    rows = [f"point_embeddings.{i}.weight" for i in range(4)] + ["not_a_point_embed.weight", "no_mask_embed.weight"]
    out.update({"sam_prompt_encoder." + n: pe[n][:1] for n in rows})    # row 0, as catseg_tpu reads them
    out.update({f"sam_prompt_encoder.mask_downscaling.{j}.{p}": pe[f"mask_downscaling.{j}.{p}"]
                for j in (0, 1, 3, 4, 6) for p in _WB})
    attn = tuple(f"{m}.{p}" for m in ("q_proj", "k_proj", "v_proj", "out_proj") for p in _WB)
    d = {}
    _copy(dec, d, "", ("iou_token.weight", "mask_tokens.weight"))
    for i in range(_count_layers(dec, "transformer.layers")):
        lp = f"transformer.layers.{i}."
        for m in ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token"):
            _copy(dec, d, f"{lp}{m}.", attn)
        for m in ("norm1", "norm2", "norm3", "norm4", "mlp.lin1", "mlp.lin2"):
            _copy(dec, d, f"{lp}{m}.", _WB)
    _copy(dec, d, "transformer.final_attn_token_to_image.", attn)
    for m in ("transformer.norm_final_attn", "output_upscaling.0", "output_upscaling.1", "output_upscaling.3"):
        _copy(dec, d, m + ".", _WB)
    mlps = [f"output_hypernetworks_mlps.{i}" for i in range(dec["mask_tokens.weight"].shape[0])]
    for m in mlps + ["iou_prediction_head"]:
        for j in range(3):
            _copy(dec, d, f"{m}.layers.{j}.", _WB)
    out.update({"sam_decoder." + k: v for k, v in d.items()})
    return out


def _strip(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def convert_catseg_checkpoint(sd: dict, num_layers: int | None = None) -> dict[str, torch.Tensor]:
    """A released CAT-Seg state dict (detectron2 names:
    ``sem_seg_head.predictor.{clip_model,transformer}.*``, ``upsample{1,2}.*``)
    -> the port's model state dict: a ``CATSeg``'s, or with the fork's
    fusion modules a ``DualEncoderCATSeg``'s (Ver31: ``fusion_corr`` in the
    aggregator, ``dino_model.``) or a ``SAMRefineCATSeg``'s (Ver14:
    ``sam_encoder.``)."""
    agg = {k: v for k, v in _strip(sd, AGG_PREFIX).items() if not k.endswith("attn_mask")}
    agg_convert = convert_fusion_aggregator_state_dict if "fusion_corr.weight" in agg else convert_aggregator_state_dict
    out = {CLIP_PREFIX + k: v for k, v in convert_clip_state_dict(_strip(sd, CLIP_PREFIX)).items()}
    out.update({AGG_PREFIX + k: v for k, v in agg_convert(agg, num_layers).items()})
    out.update(_f32({f"upsample{i}.{p}": sd[f"upsample{i}.{p}"] for i in (1, 2) for p in _WB}))
    if any(k.startswith("dino_model.") for k in sd):
        out.update({"dino_model." + k: v for k, v in convert_dino_state_dict(_strip(sd, "dino_model.")).items()})
        out.update(_f32({f"{m}.{p}": sd[f"{m}.{p}"] for m in ("dino_down_sample", "dino_decod_proj1",
                                                             "dino_decod_proj2") for p in _WB}))
    if any(k.startswith("sam_encoder.") for k in sd):
        out.update({"sam_encoder." + k: v for k, v in convert_sam_state_dict(_strip(sd, "sam_encoder.")).items()})
        out.update(convert_sam_prompt_decoder(_strip(sd, "sam_prompt_encoder."), _strip(sd, "sam_decoder.")))
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
