"""Parameter pytree -> reference-named torch state dict (numpy only).

The port's own copy of the part of catseg_tpu/weights/export.py that
``export_catseg_checkpoint`` needs for a plain CAT-Seg pytree: the released
checkpoints' key names (``sem_seg_head.predictor.*`` and ``upsample{1,2}.*``,
split ``q/k/v_proj_weight`` CLIP attention names), which are the port's
module attribute names.  Layout inverses: linear (in, out) -> torch (out,
in); conv HWIO -> OIHW; conv-transpose (Cin, kh, kw, Cout) -> (Cin, Cout, kh,
kw); stacked transformer blocks unstacked onto per-layer keys.  The fork's
SAM / DINO / fusion pytrees are not ported and are refused.
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


def export_aggregator_state_dict(agg: dict) -> dict:
    """aggregator pytree -> unprefixed Aggregator-named state dict
    (model.py:558 module tree)."""
    sd: dict = {
        "conv1.weight": _conv(agg["conv1"]["w"]),
        "conv1.bias": _np(agg["conv1"]["b"]),
        "head.weight": _conv(agg["head"]["w"]),
        "head.bias": _np(agg["head"]["b"]),
    }
    if "guidance_proj" in agg:
        sd["guidance_projection.0.weight"] = _conv(agg["guidance_proj"]["w"])
        sd["guidance_projection.0.bias"] = _np(agg["guidance_proj"]["b"])
    if "text_guidance_proj" in agg:
        sd["text_guidance_projection.0.weight"] = _t(agg["text_guidance_proj"]["w"])
        sd["text_guidance_projection.0.bias"] = _np(agg["text_guidance_proj"]["b"])
    if "decoder_guidance_proj" in agg:
        for i, proj in enumerate(agg["decoder_guidance_proj"]):
            sd[f"decoder_guidance_projection.{i}.0.weight"] = _conv(proj["w"])
            sd[f"decoder_guidance_projection.{i}.0.bias"] = _np(proj["b"])
    for i, layer in enumerate(agg["layers"]):
        _swin_block(sd, f"layers.{i}.swin_block.block_1", layer["swin1"])
        _swin_block(sd, f"layers.{i}.swin_block.block_2", layer["swin2"])
        _ln(sd, f"layers.{i}.swin_block.guidance_norm", layer["guidance_norm"])
        _class_layer(sd, f"layers.{i}.attention", layer["class"])
    _up(sd, "decoder1", agg["decoder1"])
    _up(sd, "decoder2", agg["decoder2"])
    return sd


def export_catseg_checkpoint(params: dict) -> dict:
    """CATSeg params pytree -> flat numpy state dict with the released
    checkpoints' detectron2 key names."""
    extra = sorted({"sam", "sam_pe", "sam_dec", "dino"} & set(params))
    if extra or "fusion_corr" in params["agg"]:
        raise NotImplementedError(f"the port has no fusion / SAM / DINO modules; got {extra or ['fusion_corr']}")
    sd = {}
    for k, v in export_clip_state_dict(params["clip"]).items():
        sd["sem_seg_head.predictor.clip_model." + k] = v
    for k, v in export_aggregator_state_dict(params["agg"]).items():
        sd["sem_seg_head.predictor.transformer." + k] = v
    sd["upsample1.weight"] = _convt(params["upsample1"]["w"])
    sd["upsample1.bias"] = _np(params["upsample1"]["b"])
    sd["upsample2.weight"] = _convt(params["upsample2"]["w"])
    sd["upsample2.bias"] = _np(params["upsample2"]["b"])
    return sd
