"""Cost-volume aggregation (catseg_tpu/core/aggregator.py), eval and train.

Module attribute names follow the keys of
``weights.export.export_aggregator_state_dict`` (the reference Aggregator's
module tree), so the JAX package's parameters load with ``strict=True``.
Activations keep the reference's channels-last layouts: the class-major
(B, T, H, W, C) slab runs through the corr-embed, Swin-pair, class-layer and
decoder kernels, each inside its ``torch.autograd.Function`` (at the train
pooling (2,2) the class layer runs on the avg-pooled grid and its output is
upsampled with align_corners); the guidance projections are ``F.conv*`` as
the reference leaves them to XLA.  With more classes than ``pad_len`` only the ``pad_len``
best-scoring classes are aggregated (top-k truncation); the others get -100.

Not ported yet (each raises rather than running something else): geometries
outside the fused stages' gates (the reference's fallback window-attention /
MLP / linear-attention kernels).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..configs import CATSegConfig
from ..kernels.class_layer import fused_class_layer, pad_contributions
from ..kernels.corr_embed import corr_embed_applicable, fused_corr_embed, l2_normalize
from ..kernels.decoder import decoder_kernel_applicable, decoder_plain, fused_decoder
from ..kernels.swin_block import fused_swin_pair
from ..ops import avg_pool2d, conv2d, group_norm, layer_norm, resize_bilinear
from .clip import LayerNorm, Linear, linear


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None


class ConvTranspose(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, k, k))
        self.bias = nn.Parameter(torch.empty(cout))


class GroupNorm(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x):
        return group_norm(x, self.weight.shape[0] // 16, self.weight, self.bias)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, guid: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.attn = nn.ModuleDict(dict(q=Linear(dim + guid, dim), k=Linear(dim + guid, dim),
                                       v=Linear(dim, dim), proj=Linear(dim, dim)))
        self.mlp = nn.ModuleDict(dict(fc1=Linear(dim, 4 * dim), fc2=Linear(4 * dim, dim)))

    def packed(self) -> dict:
        """Kernel parameters in the reference's (in, out) layout."""
        C = self.norm1.weight.shape[0]
        a = self.attn
        return {
            "ln1_g": self.norm1.weight, "ln1_b": self.norm1.bias,
            "qkv_w": torch.cat([a.q.weight[:, :C], a.k.weight[:, :C], a.v.weight], 0).t(),
            "qkv_b": torch.cat([a.q.bias, a.k.bias, a.v.bias]),
            "proj_w": a.proj.weight.t(), "proj_b": a.proj.bias,
            "ln2_g": self.norm2.weight, "ln2_b": self.norm2.bias,
            "fc1_w": self.mlp.fc1.weight.t(), "fc1_b": self.mlp.fc1.bias,
            "fc2_w": self.mlp.fc2.weight.t(), "fc2_b": self.mlp.fc2.bias,
        }


class SwinPair(nn.Module):
    def __init__(self, dim: int, guid: int):
        super().__init__()
        self.block_1 = SwinBlock(dim, guid)
        self.block_2 = SwinBlock(dim, guid)
        self.guidance_norm = LayerNorm(guid)


class ClassLayer(nn.Module):
    def __init__(self, dim: int, guid: int, pad_len: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.attention = nn.ModuleDict(dict(q=Linear(dim + guid, dim), k=Linear(dim + guid, dim),
                                            v=Linear(dim, dim)))
        # numbered children with gaps, as the reference's nn.Sequential keys
        self.MLP = nn.ModuleDict({"0": Linear(dim, 4 * dim), "2": Linear(4 * dim, dim)})
        if pad_len > 0:
            self.padding_tokens = nn.Parameter(torch.zeros(1, 1, dim))
            if guid > 0:
                self.padding_guidance = nn.Parameter(torch.zeros(1, 1, guid))

    def packed(self) -> dict:
        a = self.attention
        return {
            "ln1_g": self.norm1.weight, "ln1_b": self.norm1.bias,
            "q_w": a.q.weight.t(), "q_b": a.q.bias, "k_w": a.k.weight.t(), "k_b": a.k.bias,
            "v_w": a.v.weight.t(), "v_b": a.v.bias,
            "ln2_g": self.norm2.weight, "ln2_b": self.norm2.bias,
            "mlp1_w": self.MLP["0"].weight.t(), "mlp1_b": self.MLP["0"].bias,
            "mlp2_w": self.MLP["2"].weight.t(), "mlp2_b": self.MLP["2"].bias,
        }


class AggregatorLayer(nn.Module):
    def __init__(self, cfg: CATSegConfig):
        super().__init__()
        self.swin_block = SwinPair(cfg.hidden_dim, cfg.appearance_guidance_proj_dim)
        self.attention = ClassLayer(cfg.hidden_dim, cfg.text_guidance_proj_dim, cfg.pad_len)


class Up(nn.Module):
    """ConvT(k2 s2) -> (conv3x3 -> GN(C/16) -> ReLU) x2 (model.py:520-555)."""

    def __init__(self, cin: int, cout: int, guid: int):
        super().__init__()
        self.up = ConvTranspose(cin, cin - guid, 2)
        self.conv = nn.Module()
        self.conv.double_conv = nn.ModuleDict({"0": Conv(cin, cout, 3, bias=False), "1": GroupNorm(cout),
                                               "3": Conv(cout, cout, 3, bias=False), "4": GroupNorm(cout)})

    def packed(self) -> dict:
        """Decoder-stage parameters as kernels/decoder.py takes them."""
        dc = self.conv.double_conv
        return {"up_w": self.up.weight, "up_b": self.up.bias, "conv1_w": dc["0"].weight,
                "gn1_g": dc["1"].weight, "gn1_b": dc["1"].bias, "conv2_w": dc["3"].weight,
                "gn2_g": dc["4"].weight, "gn2_b": dc["4"].bias}


class Aggregator(nn.Module):
    def __init__(self, cfg: CATSegConfig):
        super().__init__()
        hd = cfg.hidden_dim
        self.conv1 = Conv(cfg.prompt_channel, hd, 7)
        self.head = Conv(cfg.decoder_dims[1], 1, 3)
        if cfg.appearance_guidance_dim > 0:
            self.guidance_projection = nn.ModuleList(
                [Conv(cfg.appearance_guidance_dim, cfg.appearance_guidance_proj_dim, 3)])
        if cfg.text_guidance_dim > 0:
            self.text_guidance_projection = nn.ModuleList(
                [Linear(cfg.text_guidance_dim, cfg.text_guidance_proj_dim)])
        if cfg.decoder_guidance_dims[0] > 0:
            self.decoder_guidance_projection = nn.ModuleList(
                nn.ModuleList([Conv(d, dp, 3)])
                for d, dp in zip(cfg.decoder_guidance_dims, cfg.decoder_guidance_proj_dims))
        self.layers = nn.ModuleList(AggregatorLayer(cfg) for _ in range(cfg.num_layers))
        self.decoder1 = Up(hd, cfg.decoder_dims[0], cfg.decoder_guidance_proj_dims[0])
        self.decoder2 = Up(cfg.decoder_dims[0], cfg.decoder_dims[1], cfg.decoder_guidance_proj_dims[1])


def correlation(img_feats: torch.Tensor, text_feats: torch.Tensor) -> torch.Tensor:
    """Cosine cost volume: (B, H, W, C) x (B, T, P, C) -> (B, T, H, W, P)."""
    img = l2_normalize(img_feats)
    txt = l2_normalize(text_feats)
    return torch.einsum("bhwc,btpc->bthwp", img.float(), txt.float()).to(img.dtype)


def topk_classes(corr: torch.Tensor, pad_len: int) -> torch.Tensor:
    """The pad_len classes with the highest max cost over (H, W, P): (B, pad_len)
    int64.  Ties may order differently from ``jax.lax.top_k``; every later
    stage is equivariant under a permutation of the kept classes."""
    scores = corr.float().amax(dim=(2, 3, 4))
    return torch.topk(scores, pad_len, dim=1).indices


def gather_classes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] along the class axis (axis 1)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def scatter_full_logits(logits: torch.Tensor, idx: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, pad_len, H, W) kept-class logits -> (B, T, H, W), -100 elsewhere."""
    B, _, H, W = logits.shape
    out = torch.full((B, num_classes, H, W), -100.0, dtype=logits.dtype, device=logits.device)
    out[torch.arange(B, device=logits.device)[:, None], idx] = logits
    return out


def corr_embed(corr: torch.Tensor, agg: Aggregator) -> torch.Tensor:
    """Per-class 7x7 conv P -> hidden: (B, T, H, W, P) -> (B, T, H, W, C)."""
    B, T, H, W, P = corr.shape
    x = conv2d(corr.reshape(B * T, H, W, P), agg.conv1.weight, agg.conv1.bias, padding=3)
    return x.reshape(B, T, H, W, -1)


def spatial_aggregation(x: torch.Tensor, appearance_guidance, layer: AggregatorLayer,
                        cfg: CATSegConfig) -> torch.Tensor:
    """Swin pair (shift 0, then window/2) on (B, T, H, W, C); guidance (B, H, W, Cg)."""
    sp = layer.swin_block
    B, T, H, W, C = x.shape
    win = cfg.window_size
    if not (C % 128 == 0 and H % win == 0 and W % win == 0 and C % cfg.num_heads == 0):
        raise NotImplementedError(
            f"spatial aggregation at C={C}, grid {H}x{W}, window {win} needs the reference's "
            "fallback window-attention / MLP kernels, which are not ported yet (ROADMAP)")
    guid4 = None
    if appearance_guidance is not None:
        guid = layer_norm(appearance_guidance, sp.guidance_norm.weight, sp.guidance_norm.bias)
        b1, b2 = sp.block_1.attn, sp.block_2.attn
        guid4 = (linear(guid, b1.q.weight[:, C:]), linear(guid, b1.k.weight[:, C:]),
                 linear(guid, b2.q.weight[:, C:]), linear(guid, b2.k.weight[:, C:]))
    return fused_swin_pair(x, guid4, sp.block_1.packed(), sp.block_2.packed(), cfg.num_heads, win)


def class_aggregation(x: torch.Tensor, text_guidance, layer: AggregatorLayer,
                      cfg: CATSegConfig) -> torch.Tensor:
    """ClassTransformerLayer: x (B, T, H, W, C); text_guidance (B, T, Cg).

    The kernel returns x + attention + MLP; the layer then adds x once more
    (the reference's outer residual around the pooled stage)."""
    cp = layer.attention
    B, T, H, W, C = x.shape
    ph, pw = cfg.pooling_size
    if not (cfg.attention_type == "linear" and C % 128 == 0 and C % cfg.num_heads == 0
            and H % ph == 0 and W % pw == 0):
        raise NotImplementedError(
            f"class aggregation ({cfg.attention_type}, C={C}, pooling {ph}x{pw}) needs the "
            "reference's legacy class path, which is not ported yet (ROADMAP)")
    Tp = max(cfg.pad_len, T) if cfg.pad_len > 0 else T
    p = cp.packed()
    qg = kg = None
    if text_guidance is not None:
        tg = text_guidance.to(x.dtype)
        qg = linear(tg, cp.attention.q.weight[:, C:])
        kg = linear(tg, cp.attention.k.weight[:, C:])
    if Tp > T:
        pad_guid = getattr(cp, "padding_guidance", None) if text_guidance is not None else None
        pad_kv, pad_ksum = pad_contributions(
            cp.padding_tokens.reshape(-1), None if pad_guid is None else pad_guid.reshape(-1),
            p, Tp - T, Tp, cfg.num_heads)
    else:
        pad_kv = torch.zeros((C, C), device=x.device)
        pad_ksum = torch.zeros((1, C), device=x.device)
    xk = x
    if (ph, pw) != (1, 1):
        xk = avg_pool2d(x.reshape(B * T, H, W, C), (ph, pw))
        xk = xk.reshape(B, T, *xk.shape[1:])
    out = fused_class_layer(xk, qg, kg, pad_kv, pad_ksum, p, cfg.num_heads, Tp)
    if (ph, pw) != (1, 1):
        out = resize_bilinear(out.reshape(B * T, *out.shape[2:]), (H, W), align_corners=True)
        out = out.reshape(B, T, H, W, C)
    return x + out


def conv_decoder(x: torch.Tensor, guidance: list, agg: Aggregator, use_fused: bool) -> torch.Tensor:
    """(B, T, 24, 24, C) -> (B, T, 96, 96) fp32 per-class logits.

    The decoder kernel where the reference's gate holds (``use_fused``, both
    decoder guidances, the flagship geometry); the plain _up_tail pair
    otherwise, as the reference runs off the TPU.  On the CPU the kernel's
    wrapper runs the same plain pair."""
    B, T, H, W, C = x.shape
    x = x.reshape(B * T, H, W, C)
    d1, d2 = agg.decoder1.packed(), agg.decoder2.packed()
    head = {"w": agg.head.weight, "b": agg.head.bias}
    if (use_fused and guidance[0] is not None and guidance[1] is not None
            and decoder_kernel_applicable(x, d1, d2)):
        out = fused_decoder(x, guidance[0], guidance[1], d1, d2, head)
    else:
        out = decoder_plain(x, guidance[0], guidance[1], d1, d2, head)
    return out.reshape(B, T, out.shape[1], out.shape[2])


def aggregator_forward(agg: Aggregator, img_feats: torch.Tensor, text_feats: torch.Tensor,
                       appearance_guidance: tuple, cfg: CATSegConfig, return_classes: bool = False):
    """img_feats (B, 24, 24, E); text_feats (B, T, P, E); appearance_guidance
    (res3 (B,24,24,Cg), res4 (B,48,48,256), res5 (B,96,96,128)) -> (B, T, 96, 96)
    fp32 logits; when T > pad_len only the top-k classes are aggregated and
    the rest get -100.

    With ``return_classes`` the scatter is left to the caller: returns
    ``(logits, classes)``, logits over the kept classes only ((B, pad_len, 96,
    96) and classes (B, pad_len) when truncation fired; otherwise all T and
    classes None)."""
    T = text_feats.shape[1]
    w_hwio = agg.conv1.weight.permute(2, 3, 1, 0)
    fused_ok = corr_embed_applicable(img_feats, text_feats, w_hwio)
    classes = None
    if cfg.pad_len > 0 and T > cfg.pad_len:
        corr = correlation(img_feats, text_feats)          # the full-T cost, for top-k only
        classes = topk_classes(corr, cfg.pad_len)
        text_feats = gather_classes(l2_normalize(text_feats), classes)
        if fused_ok:
            # the kernel recomputes the kept classes' cost from their text
            x = fused_corr_embed(img_feats, text_feats, w_hwio, agg.conv1.bias)
        else:
            x = corr_embed(gather_classes(corr, classes), agg)
    elif fused_ok:
        x = fused_corr_embed(img_feats, l2_normalize(text_feats), w_hwio, agg.conv1.bias)
    else:
        x = corr_embed(correlation(img_feats, text_feats), agg)

    proj_guid = None
    if hasattr(agg, "guidance_projection"):
        gp = agg.guidance_projection[0]
        proj_guid = torch.relu(conv2d(appearance_guidance[0], gp.weight, gp.bias, padding=1))
    dec_guid = [None, None]
    if hasattr(agg, "decoder_guidance_projection"):
        dec_guid = [torch.relu(conv2d(g, p[0].weight, p[0].bias, padding=1))
                    for p, g in zip(agg.decoder_guidance_projection, appearance_guidance[1:])]
    text_guid = None
    if hasattr(agg, "text_guidance_projection"):
        tf = text_feats.float().mean(-2)
        tf = tf / tf.norm(dim=-1, keepdim=True)
        tp = agg.text_guidance_projection[0]
        text_guid = torch.relu(linear(tf.to(x.dtype), tp.weight, tp.bias))

    for layer in agg.layers:
        x = spatial_aggregation(x, proj_guid, layer, cfg)
        x = class_aggregation(x, text_guid, layer, cfg)
    logits = conv_decoder(x, dec_guid, agg, use_fused=cfg.fused_decoder)
    if return_classes:
        return logits, classes
    if classes is not None:
        logits = scatter_full_logits(logits, classes, T)
    return logits
