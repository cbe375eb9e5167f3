"""Parameter pytree -> reference-named torch state dict (numpy only).

The port's own copy of catseg_tpu/weights/export.py's
``export_catseg_checkpoint``: the released checkpoints' key names
(``sem_seg_head.predictor.*`` and ``upsample{1,2}.*``, split
``q/k/v_proj_weight`` CLIP attention names), which are the port's module
attribute names, and the fork's fusion layouts: Ver31's DINO modules
(``dino_model.``, ``dino_down_sample``, ``dino_decod_proj{1,2}``) and
FusionAggregatorVer31 names, Ver14's Meta-SAM-named ``sam_encoder.``,
``sam_prompt_encoder.`` and ``sam_decoder.`` modules.  Layout inverses:
linear (in, out) -> torch (out, in); conv HWIO -> OIHW; conv-transpose (Cin,
kh, kw, Cout) -> (Cin, Cout, kh, kw); stacked transformer blocks unstacked
onto per-layer keys.
"""

from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(_np(w).T)


def _conv(w) -> np.ndarray:
    """HWIO -> torch OIHW."""
    return np.ascontiguousarray(np.transpose(_np(w), (3, 2, 0, 1)))


def _convt(w) -> np.ndarray:
    """(Cin, kh, kw, Cout) -> torch ConvTranspose2d (Cin, Cout, kh, kw)."""
    return np.ascontiguousarray(np.transpose(_np(w), (0, 3, 1, 2)))


def _ln(out: dict, prefix: str, p: dict) -> None:
    out[prefix + ".weight"] = _np(p["g"])
    out[prefix + ".bias"] = _np(p["b"])


def _unstack(blocks: dict, i: int) -> dict:
    out = {}
    for k, v in blocks.items():
        out[k] = _unstack(v, i) if isinstance(v, dict) else _np(v)[i]
    return out


def _clip_block(out: dict, prefix: str, b: dict, split_qkv: bool) -> None:
    if split_qkv:  # released-checkpoint names (model_vpt.py:171-180)
        out[prefix + ".attn.q_proj_weight"] = _t(b["q_w"])
        out[prefix + ".attn.k_proj_weight"] = _t(b["k_w"])
        out[prefix + ".attn.v_proj_weight"] = _t(b["v_w"])
    else:
        out[prefix + ".attn.in_proj_weight"] = np.concatenate(
            [_t(b["q_w"]), _t(b["k_w"]), _t(b["v_w"])], axis=0)
    out[prefix + ".attn.in_proj_bias"] = np.concatenate(
        [_np(b["q_b"]), _np(b["k_b"]), _np(b["v_b"])])
    out[prefix + ".attn.out_proj.weight"] = _t(b["out_w"])
    out[prefix + ".attn.out_proj.bias"] = _np(b["out_b"])
    _ln(out, prefix + ".ln_1", b["ln_1"])
    _ln(out, prefix + ".ln_2", b["ln_2"])
    out[prefix + ".mlp.c_fc.weight"] = _t(b["fc_w"])
    out[prefix + ".mlp.c_fc.bias"] = _np(b["fc_b"])
    out[prefix + ".mlp.c_proj.weight"] = _t(b["proj_w"])
    out[prefix + ".mlp.c_proj.bias"] = _np(b["proj_b"])


def export_clip_state_dict(clip: dict, split_qkv: bool = True) -> dict:
    """clip pytree -> unprefixed OpenAI-CLIP-named state dict."""
    vis, txt = clip["visual"], clip["text"]
    sd: dict = {
        "visual.conv1.weight": _conv(vis["conv1_w"]),
        "visual.class_embedding": _np(vis["class_embedding"]),
        "visual.positional_embedding": _np(vis["positional_embedding"]),
        "visual.proj": _np(vis["proj"]),
        "token_embedding.weight": _np(txt["token_embedding"]),
        "positional_embedding": _np(txt["positional_embedding"]),
        "text_projection": _np(txt["text_projection"]),
        "logit_scale": _np(clip.get("logit_scale", 0.0)),
    }
    _ln(sd, "visual.ln_pre", vis["ln_pre"])
    _ln(sd, "visual.ln_post", vis["ln_post"])
    _ln(sd, "ln_final", txt["ln_final"])
    n_vis = _np(vis["blocks"]["q_b"]).shape[0]
    n_txt = _np(txt["blocks"]["q_b"]).shape[0]
    for i in range(n_vis):
        _clip_block(sd, f"visual.transformer.resblocks.{i}", _unstack(vis["blocks"], i), split_qkv)
    for i in range(n_txt):
        _clip_block(sd, f"transformer.resblocks.{i}", _unstack(txt["blocks"], i), split_qkv)
    if "prompt_tokens" in vis:
        sd["visual.transformer.prompt_tokens"] = _np(vis["prompt_tokens"])
    return sd


def _swin_block(out: dict, prefix: str, p: dict) -> None:
    _ln(out, prefix + ".norm1", p["norm1"])
    _ln(out, prefix + ".norm2", p["norm2"])
    for name in ("q", "k", "v", "proj"):
        out[f"{prefix}.attn.{name}.weight"] = _t(p[f"{name}_w"])
        out[f"{prefix}.attn.{name}.bias"] = _np(p[f"{name}_b"])
    out[prefix + ".mlp.fc1.weight"] = _t(p["fc1_w"])
    out[prefix + ".mlp.fc1.bias"] = _np(p["fc1_b"])
    out[prefix + ".mlp.fc2.weight"] = _t(p["fc2_w"])
    out[prefix + ".mlp.fc2.bias"] = _np(p["fc2_b"])


def _class_layer(out: dict, prefix: str, p: dict) -> None:
    _ln(out, prefix + ".norm1", p["norm1"])
    _ln(out, prefix + ".norm2", p["norm2"])
    for name in ("q", "k", "v"):
        out[f"{prefix}.attention.{name}.weight"] = _t(p[f"{name}_w"])
        out[f"{prefix}.attention.{name}.bias"] = _np(p[f"{name}_b"])
    out[prefix + ".MLP.0.weight"] = _t(p["mlp1_w"])
    out[prefix + ".MLP.0.bias"] = _np(p["mlp1_b"])
    out[prefix + ".MLP.2.weight"] = _t(p["mlp2_w"])
    out[prefix + ".MLP.2.bias"] = _np(p["mlp2_b"])
    if "padding_tokens" in p:  # (1, 1, C) in the reference (model.py:372)
        out[prefix + ".padding_tokens"] = _np(p["padding_tokens"]).reshape(1, 1, -1)
    if "padding_guidance" in p:
        out[prefix + ".padding_guidance"] = _np(p["padding_guidance"]).reshape(1, 1, -1)


def _up(out: dict, prefix: str, p: dict) -> None:
    out[prefix + ".up.weight"] = _convt(p["up_w"])
    out[prefix + ".up.bias"] = _np(p["up_b"])
    out[prefix + ".conv.double_conv.0.weight"] = _conv(p["conv1_w"])
    _ln(out, prefix + ".conv.double_conv.1", p["gn1"])
    out[prefix + ".conv.double_conv.3.weight"] = _conv(p["conv2_w"])
    _ln(out, prefix + ".conv.double_conv.4", p["gn2"])


def _guidance_projections(sd: dict, agg: dict) -> None:
    if "guidance_proj" in agg:
        sd["guidance_projection.0.weight"] = _conv(agg["guidance_proj"]["w"])
        sd["guidance_projection.0.bias"] = _np(agg["guidance_proj"]["b"])
    if "text_guidance_proj" in agg:
        sd["text_guidance_projection.0.weight"] = _t(agg["text_guidance_proj"]["w"])
        sd["text_guidance_projection.0.bias"] = _np(agg["text_guidance_proj"]["b"])


def _layers(sd: dict, agg: dict) -> None:
    for i, layer in enumerate(agg["layers"]):
        _swin_block(sd, f"layers.{i}.swin_block.block_1", layer["swin1"])
        _swin_block(sd, f"layers.{i}.swin_block.block_2", layer["swin2"])
        _ln(sd, f"layers.{i}.swin_block.guidance_norm", layer["guidance_norm"])
        _class_layer(sd, f"layers.{i}.attention", layer["class"])


def export_aggregator_state_dict(agg: dict) -> dict:
    """aggregator pytree -> unprefixed Aggregator-named state dict
    (model.py:558 module tree)."""
    sd: dict = {
        "conv1.weight": _conv(agg["conv1"]["w"]),
        "conv1.bias": _np(agg["conv1"]["b"]),
        "head.weight": _conv(agg["head"]["w"]),
        "head.bias": _np(agg["head"]["b"]),
    }
    _guidance_projections(sd, agg)
    if "decoder_guidance_proj" in agg:
        for i, proj in enumerate(agg["decoder_guidance_proj"]):
            sd[f"decoder_guidance_projection.{i}.0.weight"] = _conv(proj["w"])
            sd[f"decoder_guidance_projection.{i}.0.bias"] = _np(proj["b"])
    _layers(sd, agg)
    _up(sd, "decoder1", agg["decoder1"])
    _up(sd, "decoder2", agg["decoder2"])
    return sd


def export_sam_state_dict(sam: dict) -> dict:
    """SAM image-encoder pytree -> Meta-SAM names (no 'image_encoder.' prefix)."""
    sd = {
        "patch_embed.proj.weight": _conv(sam["patch_w"]),
        "patch_embed.proj.bias": _np(sam["patch_b"]),
        "pos_embed": _np(sam["pos_embed"])[None],
        "neck.0.weight": _conv(sam["neck_conv1_w"]),
        "neck.2.weight": _conv(sam["neck_conv2_w"]),
    }
    _ln(sd, "neck.1", sam["neck_ln1"])
    _ln(sd, "neck.3", sam["neck_ln2"])
    for i, b in enumerate(sam["blocks"]):
        p = f"blocks.{i}"
        _ln(sd, p + ".norm1", b["ln_1"])
        _ln(sd, p + ".norm2", b["ln_2"])
        for name, key in (("attn.qkv", "qkv"), ("attn.proj", "proj"), ("mlp.lin1", "fc1"), ("mlp.lin2", "fc2")):
            sd[f"{p}.{name}.weight"] = _t(b[key + "_w"])
            sd[f"{p}.{name}.bias"] = _np(b[key + "_b"])
        sd[p + ".attn.rel_pos_h"] = _np(b["rel_pos_h"])
        sd[p + ".attn.rel_pos_w"] = _np(b["rel_pos_w"])
    return sd


def export_sam_prompt_decoder(pe: dict, dec: dict) -> dict:
    """(prompt_encoder, mask_decoder) pytrees -> Meta-SAM names under the
    'prompt_encoder.' / 'mask_decoder.' prefixes."""
    sd = {}
    p = "prompt_encoder."
    sd[p + "pe_layer.positional_encoding_gaussian_matrix"] = _np(pe["gauss"])
    for i in range(_np(pe["point_embeds"]).shape[0]):
        sd[p + f"point_embeddings.{i}.weight"] = _np(pe["point_embeds"])[i][None]
    sd[p + "not_a_point_embed.weight"] = _np(pe["not_a_point"])[None]
    sd[p + "no_mask_embed.weight"] = _np(pe["no_mask"])[None]
    for j, n in ((0, 1), (3, 2), (6, 3)):
        sd[p + f"mask_downscaling.{j}.weight"] = _conv(pe[f"mask_conv{n}_w"])
        sd[p + f"mask_downscaling.{j}.bias"] = _np(pe[f"mask_conv{n}_b"])
    _ln(sd, p + "mask_downscaling.1", pe["mask_ln1"])
    _ln(sd, p + "mask_downscaling.4", pe["mask_ln2"])

    m = "mask_decoder."

    def _attn(prefix, a):
        for nm, key in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"), ("out_proj", "out")):
            sd[f"{prefix}.{nm}.weight"] = _t(a[key + "_w"])
            sd[f"{prefix}.{nm}.bias"] = _np(a[key + "_b"])

    def _mlp(prefix, mlp):
        for j, (w, b) in enumerate(zip(mlp["ws"], mlp["bs"])):
            sd[f"{prefix}.layers.{j}.weight"] = _t(w)
            sd[f"{prefix}.layers.{j}.bias"] = _np(b)

    sd[m + "iou_token.weight"] = _np(dec["iou_token"])
    sd[m + "mask_tokens.weight"] = _np(dec["mask_tokens"])
    for i, layer in enumerate(dec["transformer"]["layers"]):
        lp = m + f"transformer.layers.{i}"
        _attn(lp + ".self_attn", layer["self_attn"])
        _attn(lp + ".cross_attn_token_to_image", layer["cross_t2i"])
        _attn(lp + ".cross_attn_image_to_token", layer["cross_i2t"])
        for n in range(1, 5):
            _ln(sd, lp + f".norm{n}", layer[f"norm{n}"])
        sd[lp + ".mlp.lin1.weight"] = _t(layer["fc1_w"])
        sd[lp + ".mlp.lin1.bias"] = _np(layer["fc1_b"])
        sd[lp + ".mlp.lin2.weight"] = _t(layer["fc2_w"])
        sd[lp + ".mlp.lin2.bias"] = _np(layer["fc2_b"])
    _attn(m + "transformer.final_attn_token_to_image", dec["transformer"]["final_attn"])
    _ln(sd, m + "transformer.norm_final_attn", dec["transformer"]["norm_final"])
    sd[m + "output_upscaling.0.weight"] = _convt(dec["up1_w"])
    sd[m + "output_upscaling.0.bias"] = _np(dec["up1_b"])
    _ln(sd, m + "output_upscaling.1", dec["up_ln"])
    sd[m + "output_upscaling.3.weight"] = _convt(dec["up2_w"])
    sd[m + "output_upscaling.3.bias"] = _np(dec["up2_b"])
    for i, mlp in enumerate(dec["hyper_mlps"]):
        _mlp(m + f"output_hypernetworks_mlps.{i}", mlp)
    _mlp(m + "iou_prediction_head", dec["iou_head"])
    return sd


def export_dino_state_dict(dino: dict) -> dict:
    """dino pytree -> facebookresearch/dino ViT names."""
    C = _np(dino["cls_token"]).shape[-1]
    sd = {
        "patch_embed.proj.weight": _conv(dino["patch_w"]),
        "patch_embed.proj.bias": _np(dino["patch_b"]),
        "cls_token": _np(dino["cls_token"]).reshape(1, 1, C),
        "pos_embed": _np(dino["pos_embed"]).reshape(1, -1, C),
    }
    _ln(sd, "norm", dino["norm"])
    blocks = dino["blocks"]
    for i in range(_np(blocks["qkv_b"]).shape[0]):
        b = _unstack(blocks, i)
        p = f"blocks.{i}"
        _ln(sd, p + ".norm1", b["ln_1"])
        _ln(sd, p + ".norm2", b["ln_2"])
        for name, key in (("attn.qkv", "qkv"), ("attn.proj", "proj"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            sd[f"{p}.{name}.weight"] = _t(b[key + "_w"])
            sd[f"{p}.{name}.bias"] = _np(b[key + "_b"])
    return sd


def export_fusion_aggregator_state_dict(agg: dict) -> dict:
    """Ver31 fusion-aggregator pytree -> FusionAggregatorVer31 names (conv1 /
    conv2 / fusion_corr, CLIP_ / DINO_ decoder-guidance projections,
    Fusiondecoder1 / 2)."""
    sd: dict = {}
    for name in ("conv1", "conv2", "fusion_corr", "head"):
        sd[name + ".weight"] = _conv(agg[name]["w"])
        sd[name + ".bias"] = _np(agg[name]["b"])
    _guidance_projections(sd, agg)
    for name, key in (("CLIP", "clip_decoder_guidance_proj"), ("DINO", "dino_decoder_guidance_proj")):
        for i, proj in enumerate(agg[key]):
            sd[f"{name}_decoder_guidance_projection.{i}.0.weight"] = _conv(proj["w"])
            sd[f"{name}_decoder_guidance_projection.{i}.0.bias"] = _np(proj["b"])
    _layers(sd, agg)
    _up(sd, "Fusiondecoder1", agg["decoder1"])
    _up(sd, "Fusiondecoder2", agg["decoder2"])
    return sd


def export_catseg_checkpoint(params: dict) -> dict:
    """CATSeg params pytree -> flat numpy state dict with the released
    checkpoints' detectron2 key names.  A Ver14 pytree's SAM modules go
    under ``sam_encoder.`` / ``sam_prompt_encoder.`` / ``sam_decoder.``; a
    Ver31 pytree's DINO modules under ``dino_model.`` / ``dino_down_sample``
    / ``dino_decod_proj{1,2}`` and its aggregator with the
    FusionAggregatorVer31 names."""
    sd = {}
    if "sam" in params:
        for k, v in export_sam_state_dict(params["sam"]).items():
            sd["sam_encoder." + k] = v
    if "sam_pe" in params or "sam_dec" in params:
        for k, v in export_sam_prompt_decoder(params["sam_pe"], params["sam_dec"]).items():
            if k.startswith("prompt_encoder."):
                sd["sam_prompt_encoder." + k[len("prompt_encoder."):]] = v
            else:
                sd["sam_decoder." + k[len("mask_decoder."):]] = v
    if "dino" in params:
        for k, v in export_dino_state_dict(params["dino"]).items():
            sd["dino_model." + k] = v
        for name, key, layout in (("dino_down_sample", "dino_down", _conv), ("dino_decod_proj1", "dino_proj1", _conv),
                                  ("dino_decod_proj2", "dino_proj2", _convt)):
            sd[name + ".weight"] = layout(params[key]["w"])
            sd[name + ".bias"] = _np(params[key]["b"])
    for k, v in export_clip_state_dict(params["clip"]).items():
        sd["sem_seg_head.predictor.clip_model." + k] = v
    agg_export = (export_fusion_aggregator_state_dict
                  if "fusion_corr" in params["agg"] else export_aggregator_state_dict)
    for k, v in agg_export(params["agg"]).items():
        sd["sem_seg_head.predictor.transformer." + k] = v
    sd["upsample1.weight"] = _convt(params["upsample1"]["w"])
    sd["upsample1.bias"] = _np(params["upsample1"]["b"])
    sd["upsample2.weight"] = _convt(params["upsample2"]["w"])
    sd["upsample2.bias"] = _np(params["upsample2"]["b"])
    return sd
