"""SAM prompt encoder and two-way-transformer mask decoder
(catseg_tpu/core/sam_decoder.py) as nn.Modules.

Meta SAM's PositionEmbeddingRandom (random-Fourier coordinates), prompt
encoding of points, boxes and masks, the TwoWayTransformer and the
MaskDecoder with its hypernetwork MLPs and IoU head; the Ver14 fusion
family feeds per-class coarse logit maps as mask prompts through them.
Attribute names are the checkpoint's (``pe_layer``, ``point_embeddings``,
``mask_downscaling``; ``iou_token``, ``mask_tokens``, ``transformer``,
``output_upscaling``, ``output_hypernetworks_mlps``, ``iou_prediction_head``),
as ``weights.export.export_sam_prompt_decoder`` emits them.

Dtypes follow the reference's promotion: the tokens are fp32 (the
parameters' dtype), the image embedding in the compute dtype, and a sum of
the two is fp32, so after the first cross attention the keys are fp32 too.
Attention is the reference's plain composition; the final upscaling GELU is
the tanh form (``jax.nn.gelu``'s default there), every other GELU exact.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import conv2d, conv_transpose2d_nonoverlap, plain_attention
from .aggregator import Conv, ConvTranspose
from .clip import LayerNorm, Linear, Weight
from .sam import LayerNorm2d


def pe_encode(coords01: torch.Tensor, gauss: torch.Tensor) -> torch.Tensor:
    """Coordinates in [0, 1]^2, (..., 2) -> (..., 2 * num_feats) fp32."""
    c = (2.0 * coords01 - 1.0).float() @ gauss.float()
    c = 2.0 * np.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def dense_pe(gauss: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """(h, w, C) positional encoding of the grid's cell centres (x, y)."""
    h, w = size
    ys = (np.arange(h, dtype=np.float32) + 0.5) / h
    xs = (np.arange(w, dtype=np.float32) + 0.5) / w
    coords = np.stack(np.meshgrid(xs, ys, indexing="xy"), axis=-1)
    return pe_encode(torch.from_numpy(coords).to(gauss.device), gauss)


def no_mask_embed(pe: "PromptEncoder", size: tuple[int, int]) -> torch.Tensor:
    """(1, h, w, C) dense prompt of a query without a mask prompt: the
    no-mask embedding at every cell (prompt_encoder.py:160-162)."""
    w = pe.no_mask_embed.weight
    return w.reshape(1, 1, 1, -1).expand(1, size[0], size[1], w.shape[-1])


class PromptEncoder(nn.Module):
    def __init__(self, dim: int = 256):
        super().__init__()
        self.pe_layer = nn.Module()
        self.pe_layer.positional_encoding_gaussian_matrix = nn.Parameter(torch.empty(2, dim // 2))
        self.point_embeddings = nn.ModuleList(Weight(1, dim) for _ in range(4))
        self.not_a_point_embed = Weight(1, dim)
        self.no_mask_embed = Weight(1, dim)
        self.mask_downscaling = nn.ModuleDict({"0": Conv(1, 4, 2), "1": LayerNorm2d(4), "3": Conv(4, 16, 2),
                                               "4": LayerNorm2d(16), "6": Conv(16, dim, 1)})

    @property
    def gauss(self) -> torch.Tensor:
        return self.pe_layer.positional_encoding_gaussian_matrix

    def embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """(B, 4h, 4w, 1) mask prompts -> (B, h, w, C) dense embeddings."""
        m = self.mask_downscaling
        x = F.gelu(m["1"](conv2d(masks, m["0"].weight, m["0"].bias, stride=2)))
        x = F.gelu(m["4"](conv2d(x, m["3"].weight, m["3"].bias, stride=2)))
        return conv2d(x, m["6"].weight, m["6"].bias)

    def embed_points(self, points: torch.Tensor, labels: torch.Tensor, input_size: tuple[int, int]) -> torch.Tensor:
        """points (B, N, 2) pixel xy, labels (B, N) in {-1, 0, 1} -> (B, N, C)."""
        h, w = input_size
        coords = (points + 0.5) / torch.tensor([w, h], dtype=torch.float32, device=points.device)
        emb = pe_encode(coords, self.gauss)
        lab = labels[..., None]
        emb = torch.where(lab == -1, self.not_a_point_embed.weight[0], emb)
        emb = emb + torch.where(lab == 0, self.point_embeddings[0].weight[0], 0.0)
        return emb + torch.where(lab == 1, self.point_embeddings[1].weight[0], 0.0)

    def embed_boxes(self, boxes: torch.Tensor, input_size: tuple[int, int]) -> torch.Tensor:
        """boxes (B, 4) xyxy -> (B, 2, C) corner embeddings."""
        h, w = input_size
        corners = (boxes.reshape(-1, 2, 2) + 0.5) / torch.tensor([w, h], dtype=torch.float32, device=boxes.device)
        emb = pe_encode(corners, self.gauss)
        return emb + torch.stack([self.point_embeddings[2].weight[0], self.point_embeddings[3].weight[0]])


class Attention(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.q_proj, self.k_proj = Linear(dim, inner), Linear(dim, inner)
        self.v_proj, self.out_proj = Linear(dim, inner), Linear(inner, dim)

    def forward(self, q, k, v, heads: int) -> torch.Tensor:
        B, Nq = q.shape[:2]
        qp, kp, vp = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        Ci = qp.shape[-1]
        D = Ci // heads
        qp, kp, vp = (t.reshape(B, -1, heads, D).transpose(1, 2) for t in (qp, kp, vp))
        out = plain_attention(qp / float(np.sqrt(D)), kp, vp)
        return self.out_proj(out.transpose(1, 2).reshape(B, Nq, Ci))


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, down: int):
        super().__init__()
        self.self_attn = Attention(dim, dim)
        self.norm1 = LayerNorm(dim)
        self.cross_attn_token_to_image = Attention(dim, dim // down)
        self.norm2 = LayerNorm(dim)
        self.mlp = nn.ModuleDict(dict(lin1=Linear(dim, mlp_dim), lin2=Linear(mlp_dim, dim)))
        self.norm3 = LayerNorm(dim)
        self.cross_attn_image_to_token = Attention(dim, dim // down)
        self.norm4 = LayerNorm(dim)


class TwoWayTransformer(nn.Module):
    def __init__(self, dim: int, depth: int, mlp_dim: int, down: int, heads: int = 8):
        super().__init__()
        self.heads = heads
        self.layers = nn.ModuleList(TwoWayBlock(dim, mlp_dim, down) for _ in range(depth))
        self.final_attn_token_to_image = Attention(dim, dim // down)
        self.norm_final_attn = LayerNorm(dim)

    def forward(self, image_emb: torch.Tensor, image_pe: torch.Tensor, tokens: torch.Tensor):
        """image_emb (B, h, w, C), image_pe (h, w, C) or (B, h, w, C), tokens
        (B, N, C) -> (queries, keys)."""
        B, h, w, C = image_emb.shape
        heads = self.heads
        keys = image_emb.reshape(B, h * w, C)
        key_pe = image_pe.reshape(-1, h * w, C).expand(B, h * w, C)
        queries = tokens
        for i, lp in enumerate(self.layers):
            if i == 0:
                queries = lp.self_attn(queries, queries, queries, heads)
            else:
                q = queries + tokens
                queries = queries + lp.self_attn(q, q, queries, heads)
            queries = lp.norm1(queries)
            q, k = queries + tokens, keys + key_pe
            queries = lp.norm2(queries + lp.cross_attn_token_to_image(q, k, keys, heads))
            queries = lp.norm3(queries + lp.mlp.lin2(torch.relu(lp.mlp.lin1(queries))))
            q, k = queries + tokens, keys + key_pe
            keys = lp.norm4(keys + lp.cross_attn_image_to_token(k, q, queries, heads))
        q, k = queries + tokens, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys, heads))
        return queries, keys


class MLP(nn.Module):
    """Linear layers with ReLU between (mask_decoder.py MLP)."""

    def __init__(self, dims: list[int]):
        super().__init__()
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, dim: int = 256, depth: int = 2, mlp_dim: int = 2048, down: int = 2,
                 num_mask_tokens: int = 4):
        super().__init__()
        self.iou_token = Weight(1, dim)
        self.mask_tokens = Weight(num_mask_tokens, dim)
        self.transformer = TwoWayTransformer(dim, depth, mlp_dim, down)
        self.output_upscaling = nn.ModuleDict({"0": ConvTranspose(dim, dim // 4, 2), "1": LayerNorm2d(dim // 4),
                                               "3": ConvTranspose(dim // 4, dim // 8, 2)})
        self.output_hypernetworks_mlps = nn.ModuleList(MLP([dim, dim, dim, dim // 8])
                                                       for _ in range(num_mask_tokens))
        self.iou_prediction_head = MLP([dim, 256, 256, num_mask_tokens])

    def forward(self, image_embeddings: torch.Tensor, image_pe: torch.Tensor, sparse_prompts: torch.Tensor,
                dense_prompts: torch.Tensor, multimask_output: bool = False):
        """(B, h, w, C) image embeddings and prompts -> (masks (B, 1 or 3, 4h,
        4w) fp32, iou_pred), mask_decoder.py:71-154's multimask slice rule."""
        B = sparse_prompts.shape[0]
        n_masks = self.mask_tokens.weight.shape[0]
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([out_tokens.expand(B, *out_tokens.shape), sparse_prompts.to(out_tokens.dtype)], dim=1)
        src = image_embeddings + dense_prompts
        hs, keys = self.transformer(src, image_pe, tokens)
        h, w, C = src.shape[1:]
        u = self.output_upscaling
        up = conv_transpose2d_nonoverlap(keys.reshape(B, h, w, C), u["0"].weight, u["0"].bias, kernel=2)
        up = F.gelu(u["1"](up))
        up = conv_transpose2d_nonoverlap(up, u["3"].weight, u["3"].bias, kernel=2)
        up = F.gelu(up.float(), approximate="tanh").to(up.dtype)
        hyper = torch.stack([mlp(hs[:, 1 + i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bnc,bhwc->bnhw", hyper.float(), up.float())
        iou_pred = self.iou_prediction_head(hs[:, 0])
        if multimask_output:
            return masks[:, 1:], iou_pred[:, 1:]
        return masks[:, :1], iou_pred[:, :1]


@torch.no_grad()
def init_prompt_decoder_(pe: PromptEncoder, dec: MaskDecoder, gen: torch.Generator) -> None:
    """Seeded init with catseg_tpu's init_sam_prompt_decoder scales: the
    Fourier matrix N(0, 1); embeddings, tokens and weights N(0, 0.02);
    biases 0; norms 1 / 0."""
    for name, p in list(pe.named_parameters()) + list(dec.named_parameters()):
        if name.endswith("bias"):
            p.zero_()
        elif "norm" in name or name.startswith(("mask_downscaling.1", "mask_downscaling.4", "output_upscaling.1")):
            p.fill_(1.0)
        else:
            std = 1.0 if name.startswith("pe_layer") else 0.02
            p.copy_(torch.randn(p.shape, generator=gen) * std)
