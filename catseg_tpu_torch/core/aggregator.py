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

Routing, by geometry alone and the same on every device: a stage takes its
fused kernel where the reference's gate holds and the port's fused kernel
takes the geometry (:func:`swin_route_fused`, :func:`class_route_fused`);
otherwise it runs the reference's unfused stage under the reference's names
(``_swin_block`` with the window-attention and MLP kernels;
``_class_attention_inner`` with the linear-attention kernel or the plain
``_full_attention``, then the MLP kernel).  Both routes compute the same
function; ``attention_type="full"`` always takes the unfused class stage.
No route picks a plain version for CUDA tensors: a kernel's wrapper is
called wherever the reference calls its kernel, and on the card a geometry
outside that kernel's ``kernel_takes`` raises there (hidden 256 or 512, a
head dim of 128, a text width not a multiple of 32: ROADMAP B9).  Only
outside the reference's own gates (corr embed's, the decoder's) does the
port run the reference's plain composition, as the reference does.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..configs import CATSegConfig
from ..kernels import class_layer, swin_block
from ..kernels.class_layer import fused_class_layer, pad_contributions
from ..kernels.corr_embed import corr_embed_applicable, fused_corr_embed, l2_normalize
from ..kernels.decoder import decoder_kernel_applicable, decoder_plain, fused_decoder
from ..kernels.linear_attn import fused_linear_attention
from ..kernels.mlp import fused_mlp
from ..kernels.swin_block import fused_swin_pair, shift_mask
from ..kernels.window_attn import fused_window_attention
from ..ops import avg_pool2d, conv2d, group_norm, layer_norm, resize_bilinear, window_partition, window_reverse
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
    """ConvT(k2 s2) -> (conv3x3 -> GN(C/16) -> ReLU) x2 (model.py:520-555);
    conv1 reads the ConvT's cin - guid channels and guid channels of each of
    ``pyramids`` guidance pyramids (2: the fork's FusionUP,
    FusionAggregator.py:757-772)."""

    def __init__(self, cin: int, cout: int, guid: int, pyramids: int = 1):
        super().__init__()
        self.up = ConvTranspose(cin, cin - guid, 2)
        self.conv = nn.Module()
        self.conv.double_conv = nn.ModuleDict({"0": Conv(cin + (pyramids - 1) * guid, cout, 3, bias=False),
                                               "1": GroupNorm(cout),
                                               "3": Conv(cout, cout, 3, bias=False), "4": GroupNorm(cout)})

    def packed(self) -> dict:
        """Decoder-stage parameters as kernels/decoder.py takes them."""
        dc = self.conv.double_conv
        return {"up_w": self.up.weight, "up_b": self.up.bias, "conv1_w": dc["0"].weight,
                "gn1_g": dc["1"].weight, "gn1_b": dc["1"].bias, "conv2_w": dc["3"].weight,
                "gn2_g": dc["4"].weight, "gn2_b": dc["4"].bias}


class Aggregator(nn.Module):
    # attribute names of the decoder-guidance projections (one per guidance
    # pyramid) and of the two decoder stages; FusionAggregator renames them
    GUIDANCE_PROJECTIONS = ("decoder_guidance_projection",)
    DECODERS = ("decoder1", "decoder2")

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
            for name in self.GUIDANCE_PROJECTIONS:
                setattr(self, name, nn.ModuleList(
                    nn.ModuleList([Conv(d, dp, 3)])
                    for d, dp in zip(cfg.decoder_guidance_dims, cfg.decoder_guidance_proj_dims)))
        self.layers = nn.ModuleList(AggregatorLayer(cfg) for _ in range(cfg.num_layers))
        gp, n = cfg.decoder_guidance_proj_dims, len(self.GUIDANCE_PROJECTIONS)
        setattr(self, self.DECODERS[0], Up(hd, cfg.decoder_dims[0], gp[0], n))
        setattr(self, self.DECODERS[1], Up(cfg.decoder_dims[0], cfg.decoder_dims[1], gp[1], n))


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


def swin_route_fused(x_shape, cfg: CATSegConfig) -> bool:
    """The Swin stage takes the fused pair: the reference's gate (C % 128,
    whole windows, C % heads) holds and the port's kernel takes the geometry."""
    B, T, H, W, C = x_shape
    return swin_block.kernel_takes(C, cfg.num_heads, cfg.window_size, H, W)


def _swin_block(x: torch.Tensor, guid, blk: SwinBlock, cfg: CATSegConfig, shift: int) -> torch.Tensor:
    """One unfused Swin block over (B, T, H, W, C), guidance (B, H, W, Cg)
    normed or None: LN, qkv (the guidance half of q/k once per image), the
    window-attention kernel, proj, residual, LN, the GELU MLP kernel, residual."""
    B, T, H, W, C = x.shape
    win, heads = cfg.window_size, cfg.num_heads
    N = win * win
    a = blk.attn

    def shift_part(t):
        if shift > 0:
            t = torch.roll(t, (-shift, -shift), dims=(1, 2))
        return window_partition(t, win).reshape(t.shape[0], -1, N, t.shape[-1])

    y = layer_norm(x, blk.norm1.weight, blk.norm1.bias)
    xw = shift_part(y.reshape(B * T, H, W, C))                     # (BT, nW, N, C)
    nW = xw.shape[1]
    qkv = linear(xw, torch.cat([a.q.weight[:, :C], a.k.weight[:, :C], a.v.weight]),
                 torch.cat([a.q.bias, a.k.bias, a.v.bias]))
    q, k, v = qkv.split(C, dim=-1)
    if guid is not None:
        gw = shift_part(guid)                                        # (B, nW, N, Cg)
        qg, kg = linear(gw, a.q.weight[:, C:]), linear(gw, a.k.weight[:, C:])
        q = (q.reshape(B, T, nW, N, C) + qg[:, None]).reshape(B * T, nW, N, C)
        k = (k.reshape(B, T, nW, N, C) + kg[:, None]).reshape(B * T, nW, N, C)
    mask = shift_mask(H, W, win, shift, x.device) if shift > 0 else None
    # v (and q, k without guidance) stay views of qkv, rows 3C apart: the
    # kernel takes row strides, so nothing is copied.  Rows C or 3C apart
    # that start 0, C or 2C elements into a fresh allocation are multiples
    # of 8 elements apart and 16-byte aligned wherever kernel_takes holds
    # (its head dims are multiples of 8): no layout the kernel refuses
    out = fused_window_attention(q.reshape(-1, N, C), k.reshape(-1, N, C), v.reshape(-1, N, C), mask,
                                 heads, (C // heads) ** -0.5)
    out = window_reverse(linear(out, a.proj.weight, a.proj.bias), win, H, W)
    if shift > 0:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    x = x + out.reshape(B, T, H, W, C)
    y = layer_norm(x, blk.norm2.weight, blk.norm2.bias)
    m = blk.mlp
    return x + fused_mlp(y, m.fc1.weight.t(), m.fc1.bias, m.fc2.weight.t(), m.fc2.bias, "gelu")


def swin_pair_unfused(x: torch.Tensor, appearance_guidance, layer: AggregatorLayer,
                      cfg: CATSegConfig) -> torch.Tensor:
    """The Swin pair as two unfused blocks (shift 0, then window/2)."""
    sp = layer.swin_block
    guid = None
    if appearance_guidance is not None:
        guid = layer_norm(appearance_guidance, sp.guidance_norm.weight, sp.guidance_norm.bias)
    x = _swin_block(x, guid, sp.block_1, cfg, 0)
    return _swin_block(x, guid, sp.block_2, cfg, cfg.window_size // 2)


def spatial_aggregation(x: torch.Tensor, appearance_guidance, layer: AggregatorLayer,
                        cfg: CATSegConfig) -> torch.Tensor:
    """Swin pair (shift 0, then window/2) on (B, T, H, W, C); guidance (B, H, W, Cg)."""
    if not swin_route_fused(x.shape, cfg):
        return swin_pair_unfused(x, appearance_guidance, layer, cfg)
    sp = layer.swin_block
    C = x.shape[-1]
    guid4 = None
    if appearance_guidance is not None:
        guid = layer_norm(appearance_guidance, sp.guidance_norm.weight, sp.guidance_norm.bias)
        b1, b2 = sp.block_1.attn, sp.block_2.attn
        guid4 = (linear(guid, b1.q.weight[:, C:]), linear(guid, b1.k.weight[:, C:]),
                 linear(guid, b2.q.weight[:, C:]), linear(guid, b2.k.weight[:, C:]))
    return fused_swin_pair(x, guid4, sp.block_1.packed(), sp.block_2.packed(), cfg.num_heads, cfg.window_size)


def class_route_fused(x_shape, cfg: CATSegConfig) -> bool:
    """The class stage takes the fused layer: linear attention, the
    reference's gate (C % 128, C % heads, a pooling that divides the grid)
    holds and the port's kernel takes the geometry."""
    B, T, H, W, C = x_shape
    ph, pw = cfg.pooling_size
    return (cfg.attention_type == "linear" and H % ph == 0 and W % pw == 0
            and class_layer.kernel_takes(C, cfg.num_heads, T))


def _full_attention(q, k, v):
    """Softmax attention over the class axis, q/k/v (N, T, heads, D): fp32
    logits scaled after the product (in the gemm's epilogue), fp32 softmax,
    the probabilities cast to q's dtype, then the value product in fp32 (not
    SDPA, whose bf16 rounding differs)."""
    N, T, heads, D = q.shape
    qh, kh, vh = (t.transpose(1, 2).float().reshape(N * heads, T, D) for t in (q, k, v))
    logits = torch.baddbmm(qh.new_zeros(()), qh, kh.transpose(1, 2), beta=0, alpha=D ** -0.5)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    del logits
    out = torch.bmm(attn.float(), vh).to(q.dtype)
    return out.reshape(N, heads, T, D).transpose(1, 2)


def _class_attention_inner(x: torch.Tensor, guidance, cp: ClassLayer, cfg: CATSegConfig,
                           n_pos: int = 1) -> torch.Tensor:
    """AttentionLayer on x (N, T, C); guidance (N // n_pos, T, Cg) or None,
    its share of the q/k projections computed once per (image, class) and
    broadcast over the n_pos positions."""
    heads = cfg.num_heads
    N, T, C = x.shape
    a = cp.attention
    q = linear(x, a.q.weight[:, :C], a.q.bias)
    k = linear(x, a.k.weight[:, :C], a.k.bias)
    if guidance is not None:
        g = guidance.to(x.dtype)
        qg, kg = linear(g, a.q.weight[:, C:]), linear(g, a.k.weight[:, C:])
        q = (q.reshape(-1, n_pos, T, C) + qg[:, None]).reshape(N, T, C)
        k = (k.reshape(-1, n_pos, T, C) + kg[:, None]).reshape(N, T, C)
    v = linear(x, a.v.weight, a.v.bias)
    if cfg.attention_type == "linear":
        return fused_linear_attention(q, k, v, heads)
    if cfg.attention_type == "full":
        return _full_attention(*(t.reshape(N, T, heads, -1) for t in (q, k, v))).reshape(N, T, C)
    raise ValueError(f"unknown attention_type {cfg.attention_type!r}")


def class_layer_unfused(x: torch.Tensor, text_guidance, layer: AggregatorLayer,
                        cfg: CATSegConfig) -> torch.Tensor:
    """The reference's legacy class stage: avg-pool, pad the class axis with
    the learnable token (and guidance), LN, attention across classes, LN,
    the ReLU MLP kernel, drop the padding, align-corners upsample, outer
    residual."""
    cp = layer.attention
    B, T, H, W, C = x.shape
    xp = avg_pool2d(x.reshape(B * T, H, W, C), cfg.pooling_size)
    Hp, Wp = xp.shape[1], xp.shape[2]
    xp = xp.reshape(B, T, Hp, Wp, C)
    pad = cfg.pad_len - T if cfg.pad_len > 0 else 0
    if pad > 0:
        xp = torch.cat([xp, cp.padding_tokens.reshape(C).to(xp.dtype).expand(B, pad, Hp, Wp, C)], dim=1)
        if text_guidance is not None:
            Cg = text_guidance.shape[-1]
            pad_guid = cp.padding_guidance.reshape(Cg).to(text_guidance.dtype).expand(B, pad, Cg)
            text_guidance = torch.cat([text_guidance, pad_guid], dim=1)
    Tp = xp.shape[1]
    seq = xp.permute(0, 2, 3, 1, 4).reshape(B * Hp * Wp, Tp, C)
    normed = layer_norm(seq, cp.norm1.weight, cp.norm1.bias)
    seq = seq + _class_attention_inner(normed, text_guidance, cp, cfg, n_pos=Hp * Wp)
    normed = layer_norm(seq, cp.norm2.weight, cp.norm2.bias)
    m1, m2 = cp.MLP["0"], cp.MLP["2"]
    seq = seq + fused_mlp(normed, m1.weight.t(), m1.bias, m2.weight.t(), m2.bias, "relu")
    out = seq.reshape(B, Hp, Wp, Tp, C).permute(0, 3, 1, 2, 4)[:, :T].reshape(B * T, Hp, Wp, C)
    out = resize_bilinear(out, (H, W), align_corners=True)
    return x + out.reshape(B, T, H, W, C)


def class_aggregation(x: torch.Tensor, text_guidance, layer: AggregatorLayer,
                      cfg: CATSegConfig) -> torch.Tensor:
    """ClassTransformerLayer: x (B, T, H, W, C); text_guidance (B, T, Cg).

    The fused kernel returns x + attention + MLP; the layer then adds x once
    more (the reference's outer residual around the pooled stage)."""
    if not class_route_fused(x.shape, cfg):
        return class_layer_unfused(x, text_guidance, layer, cfg)
    cp = layer.attention
    B, T, H, W, C = x.shape
    ph, pw = cfg.pooling_size
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
    # the reference's gate: its kernel there (raising on the card outside
    # the port's kernel_takes), its plain composition elsewhere.  img_feats
    # may be a view one token into CLIP's output: E elements, a multiple of
    # 32 wherever the kernel takes it, so 16-byte aligned
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
