"""One class-attention transformer layer on class-major input: CUDA kernel +
plain PyTorch version.

Replaces catseg_tpu/kernels/class_layer.py:fused_class_layer (Pallas
_kernel, _kernel_v2 and _kernel_v3; one Hopper kernel for all three).  The
kernel (csrc/class_layer.cu) runs one CTA per (position, image) over the T
class rows at stride H*W*C; its note there says what bounds it on the card.
The spec is the reference's ``_reference``: q and k stay fp32 through the
guidance add and elu+1, linear attention adds the learnable padding rows as
constant KV / K-sum terms (:func:`pad_contributions`).
"""

from __future__ import annotations

import torch

from . import _build
from .layer_norm import layer_norm_fp32

_EPS = 1e-6


def _elu1(x):
    return torch.where(x > 0, x + 1.0, torch.exp(x.clamp_max(0.0)))


def _blockdiag(C: int, D: int, device) -> torch.Tensor:
    i = torch.arange(C, device=device) // D
    return (i[:, None] == i[None, :]).float()


def pad_contributions(pad_token, pad_guid, p: dict, n_pad: int, Tp: int, heads: int):
    """K/V of the learnable padding row -> (pad_kv (C, C) block-diagonal,
    pad_ksum (1, C)), through the layer's ln1 and k/v projections exactly as
    a real row (plain fp32 math, outside the kernel as in the reference)."""
    C = pad_token.shape[0]
    y = layer_norm_fp32(pad_token.float()[None], p["ln1_g"], p["ln1_b"], fast=False)[0]
    k = y @ p["k_w"][:C].float() + p["k_b"].float()
    v = y @ p["v_w"].float() + p["v_b"].float()
    if pad_guid is not None:
        k = k + pad_guid.float() @ p["k_w"][C:].float()
    K = _elu1(k)
    kv = torch.outer(K, v / Tp) * n_pad
    return kv * _blockdiag(C, C // heads, kv.device), (K * n_pad).reshape(1, C)


def class_layer_plain(x: torch.Tensor, qg, kg, pad_kv, pad_ksum, p: dict, heads: int, Tp: int) -> torch.Tensor:
    """x (B, T, H, W, C) class-major -> same layout: x + attention + MLP."""
    B, T, H, W, C = x.shape
    D = C // heads
    dt = x.dtype
    fast = dt == torch.bfloat16
    x32 = x.permute(0, 2, 3, 1, 4).reshape(B, H * W, T, C).float()
    y = layer_norm_fp32(x32, p["ln1_g"], p["ln1_b"], fast).to(dt)
    qkv_w = torch.cat([p["q_w"][:C], p["k_w"][:C], p["v_w"]], dim=1).to(dt).float()
    qkv = y.float() @ qkv_w + torch.cat([p["q_b"], p["k_b"], p["v_b"]]).float()
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    if qg is not None:
        q = q + qg[:, None].float()
        k = k + kg[:, None].float()
    Qh = _elu1(q).reshape(B, H * W, T, heads, D)
    Kh = _elu1(k).reshape(B, H * W, T, heads, D)
    Vh = (v / Tp).reshape(B, H * W, T, heads, D)
    hi = torch.arange(heads, device=x.device)
    kv = torch.einsum("bnthd,bnthe->bnhde", Kh, Vh)
    kv = kv + pad_kv.float().reshape(heads, D, heads, D)[hi, :, hi, :]
    ksum = Kh.sum(2) + pad_ksum.float().reshape(heads, D)
    z = torch.einsum("bnthd,bnhd->bnth", Qh, ksum)
    attn = torch.einsum("bnthd,bnhde->bnthe", Qh, kv) * (Tp / (z[..., None] + _EPS))
    seq = (x32 + attn.reshape(B, H * W, T, C)).to(dt)
    y2 = layer_norm_fp32(seq.float(), p["ln2_g"], p["ln2_b"], fast).to(dt)
    h = torch.relu(y2.float() @ p["mlp1_w"].to(dt).float() + p["mlp1_b"].float()).to(dt)
    o = h.float() @ p["mlp2_w"].to(dt).float() + p["mlp2_b"].float()
    out = seq + o.to(dt)
    return out.reshape(B, H, W, T, C).permute(0, 3, 1, 2, 4)


# largest class count the kernel takes, in fp32 and bf16: pad_len, the count
# the top-k path hands it (kMaxT in csrc/class_layer.cu)
MAX_CLASSES = 256


def _class_layer_cuda(x, qg, kg, pad_kv, pad_ksum, p: dict, heads: int, Tp: int) -> torch.Tensor:
    B, T, H, W, C = x.shape
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"class layer kernel takes fp32 or bf16, got {dt}")
    if (C, heads) != (128, 4):
        raise NotImplementedError(f"class layer kernel is built for C=128, 4 heads; got {C}, {heads}")
    if T > MAX_CLASSES:
        raise NotImplementedError(f"class layer kernel takes at most {MAX_CLASSES} classes "
                                  f"per position; got T={T}")
    # weight matrices travel in the compute dtype (bf16 feeds the tensor
    # cores); LN parameters and biases in fp32, unrounded as in the spec
    w = {"ln1_g": p["ln1_g"].float(), "ln1_b": p["ln1_b"].float(),
         "qkv_w": torch.cat([p["q_w"][:C], p["k_w"][:C], p["v_w"]], dim=1).to(dt),
         "qkv_b": torch.cat([p["q_b"], p["k_b"], p["v_b"]]).float(),
         "ln2_g": p["ln2_g"].float(), "ln2_b": p["ln2_b"].float(),
         "m1_w": p["mlp1_w"].to(dt), "m1_b": p["mlp1_b"].float(),
         "m2_w": p["mlp2_w"].to(dt), "m2_b": p["mlp2_b"].float()}
    w = {k: v.contiguous() for k, v in w.items()}
    x = x.contiguous()
    out = torch.empty_like(x)
    has_guid = qg is not None
    if has_guid:
        qg, kg = qg.to(dt).contiguous(), kg.to(dt).contiguous()
    pkv = pad_kv.float().contiguous()
    pks = pad_ksum.float().reshape(C).contiguous()
    _build.launch("catseg_class_layer", x, out, qg, kg, pkv, pks, *w.values(),
                  B, T, H * W, int(has_guid), float(Tp), int(dt == torch.bfloat16))
    _build.count("class_layer")
    return out


def fused_class_layer(x: torch.Tensor, qg, kg, pad_kv, pad_ksum, p: dict, heads: int, Tp: int) -> torch.Tensor:
    """One class-attention layer on CLASS-major x (B, T, H, W, C), T real classes.

    qg/kg: (B, T, C) text-guidance halves of q/k, or None.  p: ln1_g/b, q_w
    (C+Cg, C), q_b, k_w, k_b, v_w (C, C), v_b, ln2_g/b, mlp1_w/b, mlp2_w/b in
    the reference's (in, out) layout.  Returns x + attention + MLP (the caller
    adds the outer residual)."""
    if x.is_cuda:
        return _class_layer_cuda(x, qg, kg, pad_kv, pad_ksum, p, heads, Tp)
    if x.device.type == "cpu":
        return class_layer_plain(x, qg, kg, pad_kv, pad_ksum, p, heads, Tp)
    raise RuntimeError(f"no class layer path for device {x.device}")
