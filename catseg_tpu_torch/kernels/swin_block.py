"""Both Swin blocks of one aggregator layer: CUDA kernel + plain PyTorch
version.

Replaces catseg_tpu/kernels/swin_block.py:fused_swin_pair (Pallas _kernel via
_pallas_pair).  The kernel (csrc/swin_block.cu) runs one launch per block,
one CTA per (window, class, image), with the cyclic shift folded into its
gather/scatter indices and the shift mask derived from index math; its note
there says what bounds it on the card.  Parameter dicts use the reference's
(in, out) layout and keys (ln1_g/b, qkv_w (C, 3C), qkv_b, proj_w/b,
ln2_g/b, fc1_w/b, fc2_w/b) so the two packages are called alike.

bf16 takes the reference's fast forms (tanh GELU, single-pass LN variance,
softmax clamped at 60 with no max pass); fp32 takes exact erf GELU, two-pass
LN and a max-subtracted softmax.  One predicate, the activation dtype, picks
the forms in the kernel and in the plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.window import window_partition, window_reverse
from . import _build
from .layer_norm import layer_norm_fp32

_KEYS = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "proj_w", "proj_b",
         "ln2_g", "ln2_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b")


def _softmax_rows(logits, fast: bool):
    if fast:
        e = torch.exp(logits.clamp_max(60.0))
    else:
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def gelu(h, fast: bool):
    if fast:
        return 0.5 * h * (1.0 + torch.tanh(0.7978845608028654 * (h + 0.044715 * h * h * h)))
    return F.gelu(h)


@functools.lru_cache(maxsize=None)
def _shift_mask_ids(H: int, W: int, window: int, shift: int) -> np.ndarray:
    """(num_windows, N) region ids of each window token on the rolled grid."""
    img = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    nh, nw = H // window, W // window
    return (img.reshape(nh, window, nw, window).transpose(0, 2, 1, 3)
            .reshape(-1, window * window).astype(np.int8))


def shift_mask(H: int, W: int, window: int, shift: int, device=None) -> torch.Tensor:
    """Additive (num_windows, N, N) fp32 mask: -100 between regions."""
    ids = torch.as_tensor(_shift_mask_ids(H, W, window, shift), device=device)
    return torch.where(ids[:, None, :] != ids[:, :, None], -100.0, 0.0).float()


def swin_pair_plain(x: torch.Tensor, guid4, p1: dict, p2: dict, heads: int, win: int) -> torch.Tensor:
    """x (B, T, H, W, C); guid4 None or (qg1, kg1, qg2, kg2) each (B, H, W, C)."""
    B, T, H, W, C = x.shape
    dt = x.dtype
    fast = dt == torch.bfloat16
    nW = (H // win) * (W // win)
    D = C // heads

    def part(a):
        return window_partition(a.reshape(B * T, H, W, C), win).reshape(B * T, nW, win * win, heads, D)

    def block(xf, qg, kg, p, shift):
        P = {k: p[k].float() if k.startswith("ln") else p[k].to(dt).float() for k in _KEYS}
        y = layer_norm_fp32(xf.float(), P["ln1_g"], P["ln1_b"], fast).to(dt)
        qkv = (y.float() @ P["qkv_w"] + P["qkv_b"]).to(dt)
        q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, T, H, W, C) for i in range(3))
        if qg is not None:
            q = q + qg[:, None].to(dt)
            k = k + kg[:, None].to(dt)
        if shift > 0:
            q, k, v = (torch.roll(a, (-shift, -shift), dims=(2, 3)) for a in (q, k, v))
        qh, kh, vh = (part(a).float().permute(0, 1, 3, 2, 4) for a in (q, k, v))
        logits = torch.matmul(qh, kh.transpose(-1, -2)) * (D ** -0.5)
        if shift > 0:
            logits = logits + shift_mask(H, W, win, shift, x.device)[None, :, None]
        attn = _softmax_rows(logits, fast).to(dt).float()
        out = torch.matmul(attn, vh).to(dt)                       # (BT, nW, heads, N, D)
        out = window_reverse(out.permute(0, 1, 3, 2, 4).reshape(B * T * nW, win * win, C), win, H, W)
        if shift > 0:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        out = out.reshape(B * T, H * W, C).float() @ P["proj_w"] + P["proj_b"]
        xf2 = xf + out.to(dt)
        y = layer_norm_fp32(xf2.float(), P["ln2_g"], P["ln2_b"], fast).to(dt)
        h = gelu(y.float() @ P["fc1_w"] + P["fc1_b"], fast).to(dt)
        o = h.float() @ P["fc2_w"] + P["fc2_b"]
        return xf2 + o.to(dt)

    qg1 = kg1 = qg2 = kg2 = None
    if guid4 is not None:
        qg1, kg1, qg2, kg2 = guid4
    xf = x.reshape(B * T, H * W, C)
    xf = block(xf, qg1, kg1, p1, 0)
    xf = block(xf, qg2, kg2, p2, win // 2)
    return xf.reshape(B, T, H, W, C)


def _swin_block_cuda(x, qg, kg, p: dict, shift: int) -> torch.Tensor:
    B, T, H, W, C = x.shape
    dt = x.dtype
    # LN parameters fp32; the rest rounded through the compute dtype, weight
    # matrices kept in it (bf16 feeds the tensor cores), biases as fp32
    w = {k: (p[k].float() if k.startswith("ln") else
             p[k].to(dt) if k.endswith("_w") else p[k].to(dt).float()).contiguous() for k in _KEYS}
    out = torch.empty_like(x)
    has_guid = qg is not None
    if has_guid:
        qg, kg = qg.to(dt).contiguous(), kg.to(dt).contiguous()
    _build.launch("catseg_swin_block", x, out, qg, kg, *(w[k] for k in _KEYS), B, T, H, W, shift,
                  int(has_guid), int(dt == torch.bfloat16))
    _build.count("swin_block")
    return out


def _swin_pair_cuda(x, guid4, p1, p2, heads: int, win: int) -> torch.Tensor:
    B, T, H, W, C = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"swin kernel takes fp32 or bf16, got {x.dtype}")
    if (C, heads, win) != (128, 4, 12) or H % win or W % win:
        raise NotImplementedError(f"swin kernel is built for C=128, 4 heads, window 12; "
                                  f"got C={C}, heads={heads}, window={win}, grid {H}x{W}")
    g = guid4 if guid4 is not None else (None,) * 4
    x = _swin_block_cuda(x.contiguous(), g[0], g[1], p1, 0)
    return _swin_block_cuda(x, g[2], g[3], p2, win // 2)


def fused_swin_pair(x: torch.Tensor, guid4, p1: dict, p2: dict, heads: int, win: int) -> torch.Tensor:
    """Both Swin blocks of one aggregator layer (shift 0, then win // 2)."""
    if x.is_cuda:
        return _swin_pair_cuda(x, guid4, p1, p2, heads, win)
    if x.device.type == "cpu":
        return swin_pair_plain(x, guid4, p1, p2, heads, win)
    raise RuntimeError(f"no swin path for device {x.device}")
