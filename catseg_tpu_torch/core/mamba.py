"""MambaIR-style 2D selective scan, SS2D and VSSBlock (catseg_tpu/core/mamba.py).

The reference vendors MambaIR's VSS blocks (cat_seg/mambaIR.py); they are
dead code in the fork, imported nowhere active (PARITY.md:71), and, as in
catseg_tpu, no model here wires them in.  The reference runs the selective
scan through the CUDA ``mamba_ssm`` kernel and catseg_tpu as a
``jax.lax.associative_scan``; here it is plain PyTorch, one step of the
linear recurrence h_l = exp(Δ_l A) h_{l-1} + Δ_l B_l x_l a position,
sequential over the sequence.  The LayerNorms go through ``ops.norm``
(kernel #1 on the card), as catseg_tpu's go through its LayerNorm kernel.

SS2D (mambaIR.py:105-277): in-projection to twice the inner width, a
depthwise conv and SiLU, four scan directions (row-major, column-major and
both reversed) with per-direction x / dt projections, the sum of the four
outputs, LayerNorm, the SiLU(z) gate, out-projection.  VSSBlock
(mambaIR.py:280-309): LN (eps 1e-6) -> SS2D with a skip scale, LN -> the CAB
conv-attention block (conv3x3, GELU, conv3x3, channel attention) with a
second skip scale.  Tensors are (B, H, W, C); parameter names are MambaIR's.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norm import layer_norm


@dataclasses.dataclass(frozen=True)
class SS2DConfig:
    d_model: int
    d_state: int = 16
    expand: float = 2.0
    d_conv: int = 3

    @property
    def d_inner(self) -> int:
        return int(self.expand * self.d_model)

    @property
    def dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)


def selective_scan(xs, dts, A, Bs, Cs, D, delta_bias) -> torch.Tensor:
    """The Mamba selective scan.  xs / dts: (B, D', L); A: (D', N); Bs / Cs:
    (B, G, N, L) with D' = G * Dg; D, delta_bias: (D',).  Returns (B, D', L)
    fp32."""
    Bsz, Dp, L = xs.shape
    G = Bs.shape[1]
    Dg = Dp // G
    xs = xs.float()
    delta = F.softplus(dts.float() + delta_bias.float()[None, :, None])              # (B, D', L)
    deltaA = torch.exp(delta[..., None] * A.float()[None, :, None, :])               # (B, D', L, N)
    Bs_e = Bs.float().repeat_interleave(Dg, dim=1).transpose(2, 3)                   # (B, D', L, N)
    Cs_e = Cs.float().repeat_interleave(Dg, dim=1).transpose(2, 3)
    deltaBu = delta[..., None] * Bs_e * xs[..., None]
    h = torch.zeros(Bsz, Dp, A.shape[1], dtype=torch.float32, device=xs.device)
    ys = []
    for l in range(L):
        h = deltaA[:, :, l] * h + deltaBu[:, :, l]
        ys.append((h * Cs_e[:, :, l]).sum(-1))
    return torch.stack(ys, dim=-1) + D.float()[None, :, None] * xs


class SS2D(nn.Module):
    """(B, H, W, C) -> (B, H, W, C) (mambaIR.py:261-277)."""

    def __init__(self, cfg: SS2DConfig):
        super().__init__()
        self.cfg = cfg
        Din, N, R, K = cfg.d_inner, cfg.d_state, cfg.dt_rank, 4
        self.in_proj = nn.Linear(cfg.d_model, 2 * Din, bias=False)
        self.conv2d = nn.Conv2d(Din, Din, cfg.d_conv, padding=(cfg.d_conv - 1) // 2, groups=Din)
        self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2 * N, Din))
        self.dt_projs_weight = nn.Parameter(torch.empty(K, Din, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, Din))
        self.A_logs = nn.Parameter(torch.empty(K * Din, N))
        self.Ds = nn.Parameter(torch.empty(K * Din))
        self.out_norm = nn.LayerNorm(Din)
        self.out_proj = nn.Linear(Din, cfg.d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, H, W, _ = x.shape
        L, Din = H * W, cfg.d_inner
        xs, z = self.in_proj(x).split(Din, dim=-1)
        xs = F.silu(self.conv2d(xs.permute(0, 3, 1, 2)))                          # (B, Din, H, W)
        x_flat = xs.reshape(B, Din, L)                                            # row-major
        x_t = xs.transpose(2, 3).reshape(B, Din, L)                               # column-major
        x4 = torch.stack([x_flat, x_t, x_flat.flip(-1), x_t.flip(-1)], dim=1)     # (B, 4, Din, L)
        x_dbl = torch.einsum("bkdl,kcd->bkcl", x4, self.x_proj_weight)
        dt, Bs, Cs = x_dbl.split([cfg.dt_rank, cfg.d_state, cfg.d_state], dim=2)
        dt = torch.einsum("bkrl,kdr->bkdl", dt, self.dt_projs_weight)
        A = -torch.exp(self.A_logs.float())
        out = selective_scan(x4.reshape(B, 4 * Din, L), dt.reshape(B, 4 * Din, L), A, Bs, Cs, self.Ds,
                             self.dt_projs_bias.reshape(-1)).reshape(B, 4, Din, L)
        inv = out[:, 2:4].flip(-1)
        y2 = out[:, 1].reshape(B, Din, W, H).transpose(2, 3).reshape(B, Din, L)
        y4 = inv[:, 1].reshape(B, Din, W, H).transpose(2, 3).reshape(B, Din, L)
        y = (out[:, 0] + y2 + inv[:, 0] + y4).transpose(1, 2).reshape(B, H, W, Din)
        y = layer_norm(y.to(x.dtype), self.out_norm.weight, self.out_norm.bias)
        return self.out_proj(y * F.silu(z))


class ChannelAttention(nn.Module):
    def __init__(self, C: int, squeeze: int):
        super().__init__()
        mid = max(C // squeeze, 1)
        self.attention = nn.ModuleDict({"1": nn.Conv2d(C, mid, 1), "3": nn.Conv2d(mid, C, 1)})


class CAB(nn.Module):
    def __init__(self, C: int, compress_ratio: int, squeeze: int):
        super().__init__()
        mid = C // compress_ratio
        self.cab = nn.ModuleDict({"0": nn.Conv2d(C, mid, 3, padding=1), "2": nn.Conv2d(mid, C, 3, padding=1),
                                  "3": ChannelAttention(C, squeeze)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, C) (mambaIR.py:17-50)."""
        c = self.cab["2"](F.gelu(self.cab["0"](x.permute(0, 3, 1, 2))))
        att = self.cab["3"].attention
        a = att["3"](F.relu(att["1"](c.mean((2, 3), keepdim=True))))
        return (c * torch.sigmoid(a)).permute(0, 2, 3, 1)


class VSSBlock(nn.Module):
    """(B, H, W, C) VSSBlock (mambaIR.py:301-309)."""

    def __init__(self, cfg: SS2DConfig, compress_ratio: int = 3, squeeze: int = 30):
        super().__init__()
        C = cfg.d_model
        self.ln_1 = nn.LayerNorm(C, eps=1e-6)
        self.self_attention = SS2D(cfg)
        self.skip_scale = nn.Parameter(torch.ones(C))
        self.ln_2 = nn.LayerNorm(C)
        self.conv_blk = CAB(C, compress_ratio, squeeze)
        self.skip_scale2 = nn.Parameter(torch.ones(C))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = layer_norm(x, self.ln_1.weight, self.ln_1.bias, eps=1e-6)
        x = x * self.skip_scale + self.self_attention(h)
        h = layer_norm(x, self.ln_2.weight, self.ln_2.bias)
        return x * self.skip_scale2 + self.conv_blk(h)


@torch.no_grad()
def init_vss_block_(block: VSSBlock, seed: int) -> VSSBlock:
    """catseg_tpu's init_vss_block distributions (not its random stream):
    normal(0.02) projections and convs, dt projections normal(dt_rank^-1/2),
    zero biases, the Mamba dt bias softplus^-1(0.01), A_log = log(1..N),
    D = 1, unit norms and skip scales."""
    gen = torch.Generator().manual_seed(seed)
    ss = block.self_attention
    N, R = ss.cfg.d_state, ss.cfg.dt_rank

    def normal_(t, scale=0.02):
        t.copy_(torch.randn(t.shape, generator=gen) * scale)

    for t in (ss.in_proj.weight, ss.conv2d.weight, ss.x_proj_weight, ss.out_proj.weight,
              block.conv_blk.cab["0"].weight, block.conv_blk.cab["2"].weight):
        normal_(t)
    att = block.conv_blk.cab["3"].attention
    for t in (att["1"].weight, att["3"].weight):
        normal_(t)
    normal_(ss.dt_projs_weight, R ** -0.5)
    for t in (ss.conv2d.bias, block.conv_blk.cab["0"].bias, block.conv_blk.cab["2"].bias, att["1"].bias,
              att["3"].bias):
        t.zero_()
    ss.dt_projs_bias.fill_(math.log(math.expm1(1e-2)))
    ss.A_logs.copy_(torch.log(torch.arange(1, N + 1, dtype=torch.float32)).expand_as(ss.A_logs))
    ss.Ds.fill_(1.0)
    for m in (block.ln_1, block.ln_2, ss.out_norm):
        m.weight.fill_(1.0)
        m.bias.zero_()
    block.skip_scale.fill_(1.0)
    block.skip_scale2.fill_(1.0)
    return block
