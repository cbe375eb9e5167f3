"""OpenAI-style CLIP encoders (catseg_tpu/core/clip.py) as nn.Modules.

Module attribute names follow the keys that
``catseg_tpu.weights.export.export_clip_state_dict`` emits (the released
checkpoints' names, split ``q/k/v_proj_weight``), so a state dict from the
JAX package loads with ``strict=True`` and no renaming table.  Linear
weights are torch (out, in); ``visual.proj`` and ``text_projection`` are
(in, out) as in the checkpoint.

Numerics follow the reference: matmuls in the compute dtype with fp32
accumulation and fp32 bias, LayerNorm statistics and softmax in fp32.  The
maskless visual attention goes through the dense-attention kernel; the
causally masked text attention takes the plain path, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs import CLIPVariant
from ..kernels.clip_attn import dense_attention_applicable, fused_dense_attention
from ..ops import layer_norm, patchify, resize_bicubic


class Linear(nn.Module):
    def __init__(self, fan_in: int, fan_out: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in))
        self.bias = nn.Parameter(torch.empty(fan_out)) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class Weight(nn.Module):
    """A bare ``weight`` parameter (conv1, token_embedding)."""

    def __init__(self, *shape: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*shape))


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """x @ w.T in x's dtype with fp32 accumulation; bias added in fp32."""
    y = F.linear(x, w.to(x.dtype))
    if b is None:
        return y
    return (y.float() + b.float()).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _act(variant: CLIPVariant):
    """OpenAI checkpoints use QuickGELU; open_clip H/G exact (erf) GELU."""
    return quick_gelu if variant.act == "quick_gelu" else F.gelu


class Attention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.q_proj_weight = nn.Parameter(torch.empty(width, width))
        self.k_proj_weight = nn.Parameter(torch.empty(width, width))
        self.v_proj_weight = nn.Parameter(torch.empty(width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)

    def qkv(self, x):
        W = x.shape[-1]
        b = self.in_proj_bias
        return (linear(x, self.q_proj_weight, b[:W]), linear(x, self.k_proj_weight, b[W:2 * W]),
                linear(x, self.v_proj_weight, b[2 * W:]))

    def forward(self, x: torch.Tensor, heads: int, mask: torch.Tensor | None) -> torch.Tensor:
        B, T, W = x.shape
        q, k, v = self.qkv(x)
        if dense_attention_applicable(W, heads, mask):
            return self.out_proj(fused_dense_attention(q, k, v, heads))
        D = W // heads
        qh, kh, vh = (t.float().reshape(B, T, heads, D).transpose(1, 2) for t in (q, k, v))
        logits = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / np.sqrt(D))
        if mask is not None:
            logits = logits + mask
        attn = torch.softmax(logits, dim=-1).to(x.dtype).float()
        out = torch.matmul(attn, vh).to(x.dtype).transpose(1, 2).reshape(B, T, W)
        return self.out_proj(out)


class MLP(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.c_fc = Linear(width, hidden)
        self.c_proj = Linear(hidden, width)

    def forward(self, x, act):
        return self.c_proj(act(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.attn = Attention(width)
        self.ln_1 = LayerNorm(width)
        self.mlp = MLP(width, hidden)
        self.ln_2 = LayerNorm(width)

    def forward(self, x, heads: int, mask, act):
        x = x + self.attn(self.ln_1(x), heads, mask)
        return x + self.mlp(self.ln_2(x), act)

    def dense_final(self, x, act):
        """The dense trick (model_vpt.py:219-240): value path + out-proj only,
        with the pre-block CLS row as the residual of every token."""
        y = self.ln_1(x)
        W = x.shape[-1]
        v = linear(y, self.attn.v_proj_weight, self.attn.in_proj_bias[2 * W:])
        v = self.attn.out_proj(v) + x[:, :1]
        return v + self.mlp(self.ln_2(v), act)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, hidden: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, hidden) for _ in range(layers))


class VisualTransformer(nn.Module):
    def __init__(self, v: CLIPVariant):
        super().__init__()
        w = v.width
        self.conv1 = Weight(w, 3, v.patch, v.patch)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(v.pretrain_grid ** 2 + 1, w))
        self.ln_pre = LayerNorm(w)
        self.transformer = Transformer(w, v.layers, v.mlp_width)
        self.ln_post = LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, v.embed_dim))

    @property
    def prompt_tokens(self) -> torch.Tensor | None:
        """The VPT prompts (depth, L, width), or None: a model has them only
        where its loaded parameters carry them (``clip_finetune="prompt"``)."""
        return getattr(self.transformer, "prompt_tokens", None)

    def add_prompt_tokens(self, depth: int, length: int) -> None:
        """Give the model zero VPT prompts of this shape, under the
        checkpoints' key ``visual.transformer.prompt_tokens``."""
        width = self.class_embedding.shape[0]
        self.transformer.prompt_tokens = nn.Parameter(torch.zeros(depth, length, width))


class CLIP(nn.Module):
    def __init__(self, v: CLIPVariant):
        super().__init__()
        self.variant = v
        self.visual = VisualTransformer(v)
        tw = v.text_width
        self.token_embedding = Weight(v.vocab_size, tw)
        self.positional_embedding = nn.Parameter(torch.empty(v.context, tw))
        self.transformer = Transformer(tw, v.text_layers, 4 * tw)
        self.ln_final = LayerNorm(tw)
        self.text_projection = nn.Parameter(torch.empty(tw, v.embed_dim))
        self.logit_scale = nn.Parameter(torch.zeros(()))


def resized_pos_embed(pe: torch.Tensor, pretrain_grid: int, grid: int) -> torch.Tensor:
    """Bicubic grid resize of a (1 + S^2, W) positional embedding."""
    if grid == pretrain_grid:
        return pe
    W = pe.shape[-1]
    g = pe[1:].reshape(1, pretrain_grid, pretrain_grid, W).float()
    g = resize_bicubic(g, (grid, grid)).reshape(grid * grid, W).to(pe.dtype)
    return torch.cat([pe[:1], g], dim=0)


def encode_image(clip: CLIP, images: torch.Tensor, taps: tuple[int, ...] = (),
                 compute_dtype=torch.float32, dense: bool = True):
    """CLIP image encoding of (B, H, W, 3) normalized images.

    Returns (tokens, [block outputs (B, 1+G^2, width) for each tap]).  Dense
    (the default): the final block runs the dense trick and tokens are
    (B, 1+G^2, embed_dim), every token after ln_post + proj; otherwise the
    final block is a standard one and tokens are the (B, embed_dim) CLS
    projection.  Tap t is the output of block t; a tap at the final block
    sees its output.  With VPT prompts (:attr:`VisualTransformer.prompt_tokens`,
    depth d) the first min(d, layers - 1) blocks run with their prompts after
    the CLS token, stripped again after the block (and before its tap)."""
    v = clip.variant
    p = clip.visual
    act = _act(v)
    B, H = images.shape[:2]
    grid = H // v.patch
    dt = compute_dtype
    x = patchify(images.to(dt), p.conv1.weight, v.patch)
    cls = p.class_embedding.to(dt).expand(B, 1, v.width)
    x = torch.cat([cls, x], dim=1)
    x = x + resized_pos_embed(p.positional_embedding, v.pretrain_grid, grid).to(dt)
    x = p.ln_pre(x)
    blocks = p.transformer.resblocks
    prompts = p.prompt_tokens
    n_prompted = 0 if prompts is None else prompts.shape[0]
    tapped = {}
    for i in range(v.layers - 1):
        if i < n_prompted:
            L = prompts.shape[1]
            xp = torch.cat([x[:, :1], prompts[i].to(x.dtype).expand(B, L, v.width), x[:, 1:]], dim=1)
            xp = blocks[i](xp, v.heads, None, act)
            x = torch.cat([xp[:, :1], xp[:, 1 + L:]], dim=1)
        else:
            x = blocks[i](x, v.heads, None, act)
        tapped[i] = x
    x = blocks[-1].dense_final(x, act) if dense else blocks[-1](x, v.heads, None, act)
    tapped[v.layers - 1] = x
    x = p.ln_post(x)
    if not dense:
        x = x[:, 0]
    return torch.matmul(x, p.proj.to(dt)), [tapped[t] for t in taps]


def encode_image_attn_maps(clip: CLIP, images: torch.Tensor, attn_layers: tuple[int, ...],
                           compute_dtype=torch.float32) -> list[torch.Tensor]:
    """Attention probability maps of selected visual blocks (catseg_tpu's
    ``encode_image_attn_maps``, viz_atten.py's forward hooks on the
    attention softmax): for each requested layer, in ascending order, the
    (B, heads, 1+G^2, 1+G^2) fp32 softmax of block i's logits.  Every block,
    the last included, runs as a standard softmax block (the dense trick has
    no attention to show); a plain softmax, as in the reference, and the
    LayerNorms through :func:`ops.layer_norm` (kernel #1 on the card)."""
    v = clip.variant
    p = clip.visual
    act = _act(v)
    B, H = images.shape[:2]
    grid = H // v.patch
    dt = compute_dtype
    x = patchify(images.to(dt), p.conv1.weight, v.patch)
    x = torch.cat([p.class_embedding.to(dt).expand(B, 1, v.width), x], dim=1)
    x = x + resized_pos_embed(p.positional_embedding, v.pretrain_grid, grid).to(dt)
    x = p.ln_pre(x)
    heads, D = v.heads, v.width // v.heads
    T = x.shape[1]
    maps = {}
    for i, blk in enumerate(p.transformer.resblocks):
        q, k, val = blk.attn.qkv(blk.ln_1(x))
        qh, kh, vh = (t.reshape(B, T, heads, D) for t in (q, k, val))
        logits = torch.einsum("bqhd,bkhd->bhqk", qh.float(), kh.float()) / np.sqrt(D)
        attn = torch.softmax(logits, dim=-1)
        if i in attn_layers:
            maps[i] = attn
        out = torch.einsum("bhqk,bkhd->bqhd", attn.to(x.dtype).float(), vh.float())
        x = x + blk.attn.out_proj(out.to(x.dtype).reshape(B, T, v.width))
        x = x + blk.mlp(blk.ln_2(x), act)
    return [maps[i] for i in sorted(set(attn_layers)) if i in maps]


def truncate_context(token_ids: np.ndarray, multiple: int = 8) -> np.ndarray:
    """Cut (N, 77) prompts to max(EOT)+1 rounded up to ``multiple``: exact
    under the causal mask, since positions <= EOT never see later ones."""
    ids = np.asarray(token_ids)
    eot = int(ids.argmax(axis=-1).max())
    n = min(ids.shape[-1], -(-(eot + 1) // multiple) * multiple)
    return ids[..., :n]


def encode_text(clip: CLIP, token_ids: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Causal text encoding with EOT pooling: (N, ctx) int ids -> (N, embed_dim)."""
    v = clip.variant
    dt = compute_dtype
    n = token_ids.shape[-1]
    x = clip.token_embedding.weight[token_ids].to(dt) + clip.positional_embedding[:n].to(dt)
    mask = torch.full((n, n), float("-inf"), device=x.device).triu(1)
    act = _act(v)
    for blk in clip.transformer.resblocks:
        x = blk(x, v.text_heads, mask, act)
    x = clip.ln_final(x)
    pooled = x[torch.arange(x.shape[0], device=x.device), token_ids.argmax(-1)]
    return torch.matmul(pooled, clip.text_projection.to(dt))


@torch.no_grad()
def init_clip_(clip: CLIP, gen: torch.Generator) -> None:
    """Seeded random init with the JAX package's scales (catseg_tpu/core/clip.py)."""
    v = clip.variant

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    w = v.width
    normal_(clip.visual.conv1.weight, w ** -0.5)
    normal_(clip.visual.class_embedding, w ** -0.5)
    normal_(clip.visual.positional_embedding, w ** -0.5)
    normal_(clip.visual.proj, w ** -0.5)
    tw = v.text_width
    normal_(clip.token_embedding.weight, 0.02)
    normal_(clip.positional_embedding, 0.01)
    normal_(clip.text_projection, tw ** -0.5)
    for tower, width in ((clip.visual.transformer, w), (clip.transformer, tw)):
        for blk in tower.resblocks:
            for p in (blk.attn.q_proj_weight, blk.attn.k_proj_weight, blk.attn.v_proj_weight,
                      blk.attn.out_proj.weight, blk.mlp.c_proj.weight):
                normal_(p, width ** -0.5)
            normal_(blk.mlp.c_fc.weight, (2 * width) ** -0.5)
            for p in (blk.attn.in_proj_bias, blk.attn.out_proj.bias, blk.mlp.c_fc.bias,
                      blk.mlp.c_proj.bias):
                p.zero_()
