"""One class-attention transformer layer on class-major input: CUDA kernel +
plain PyTorch version.

Replaces catseg_tpu/kernels/class_layer.py:fused_class_layer (Pallas
_kernel, _kernel_v2 and _kernel_v3; one Hopper kernel for all three).  The
kernel (csrc/class_layer.cu) runs one CTA per (position, image) over the T
class rows at stride H*W*C.  In bf16 it runs its products on mma.sync tensor
cores with the weights packed in fragment order (:func:`pack_mma_b`), about
15x its bound on an H100: its phases (tools/class_phases.py) are latency-
and issue-bound, none near the tensor cores' rate; its note there says more.
The spec is the reference's ``_reference``: q and k stay fp32 through the
guidance add and elu+1, linear attention adds the learnable padding rows as
constant KV / K-sum terms (:func:`pad_contributions`).

Gradients: the layer is a ``torch.autograd.Function`` over the kernel's
parameter layout (:func:`kernel_params`: q/k/v weights of the x rows
concatenated, (in, out)), so the guidance rows q_w[C:], k_w[C:] get their
gradients through qg / kg outside it, as in the reference.  Its backward on
CUDA is csrc/class_layer_bwd.cu (replaces the reference's ``_bwd`` /
``_pallas_bwd``; in bf16 on mma.sync tensor cores, its note there says
which operands go as bf16 and which as a hi + lo pair); on the CPU autograd
through the plain version.  Both
return the pad_kv / pad_ksum cotangents, which flow on through the plain
:func:`pad_contributions` into the padding rows, ln1 and k / v.  Where no
gradient is recorded, the layer is the op ``catseg_tpu_torch::class_layer``
(``kernels/ops.py``), its parameters one tensor list in ``_KP`` order.
"""

from __future__ import annotations

import torch

from . import _build
from .autograd import plain_vjp
from .layer_norm import layer_norm_fp32
from .ops import records_grad, register, serve
from .swin_block import pack_mma_b

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


# kernel_params keys, in the Function's argument order
_KP = ("ln1_g", "ln1_b", "qkv_w", "qkv_b", "ln2_g", "ln2_b", "mlp1_w", "mlp1_b", "mlp2_w", "mlp2_b")


def kernel_params(p: dict) -> dict:
    """The layer's parameters as the kernel takes them: qkv_w (C, 3C) of the
    x rows of q_w / k_w and v_w, qkv_b (3C,); the rest as given."""
    C = p["ln1_g"].shape[0]
    kp = {k: p[k] for k in _KP if k in p}
    kp["qkv_w"] = torch.cat([p["q_w"][:C], p["k_w"][:C], p["v_w"]], dim=1)
    kp["qkv_b"] = torch.cat([p["q_b"], p["k_b"], p["v_b"]])
    return kp


def _plain(x, qg, kg, pad_kv, pad_ksum, kp: dict, heads: int, Tp: int) -> torch.Tensor:
    B, T, H, W, C = x.shape
    D = C // heads
    dt = x.dtype
    fast = dt == torch.bfloat16
    x32 = x.permute(0, 2, 3, 1, 4).reshape(B, H * W, T, C).float()
    y = layer_norm_fp32(x32, kp["ln1_g"], kp["ln1_b"], fast).to(dt)
    qkv = y.float() @ kp["qkv_w"].to(dt).float() + kp["qkv_b"].float()
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
    y2 = layer_norm_fp32(seq.float(), kp["ln2_g"], kp["ln2_b"], fast).to(dt)
    h = torch.relu(y2.float() @ kp["mlp1_w"].to(dt).float() + kp["mlp1_b"].float()).to(dt)
    o = h.float() @ kp["mlp2_w"].to(dt).float() + kp["mlp2_b"].float()
    out = seq + o.to(dt)
    return out.reshape(B, H, W, T, C).permute(0, 3, 1, 2, 4)


def class_layer_plain(x: torch.Tensor, qg, kg, pad_kv, pad_ksum, p: dict, heads: int, Tp: int) -> torch.Tensor:
    """x (B, T, H, W, C) class-major -> same layout: x + attention + MLP."""
    return _plain(x, qg, kg, pad_kv, pad_ksum, kernel_params(p), heads, Tp)


# largest class count the kernel takes, in fp32 and bf16: pad_len, the count
# the top-k path hands it (kMaxT in csrc/class_layer.cu)
MAX_CLASSES = 256


def kernel_takes(C: int, heads: int, T: int) -> bool:
    """The geometries the CUDA kernel is built for: C = 128, 4 heads, at
    most MAX_CLASSES classes."""
    return (C, heads) == (128, 4) and T <= MAX_CLASSES


def _check_cuda(x, heads: int) -> None:
    B, T, H, W, C = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"class layer kernel takes fp32 or bf16, got {x.dtype}")
    if not kernel_takes(C, heads, T):
        raise NotImplementedError(f"class layer kernel is built for C=128, 4 heads and at most {MAX_CLASSES} "
                                  f"classes per position; got C={C}, heads={heads}, T={T}")


def layer_args(x, qg, kg, pad_kv, pad_ksum, kp: dict, Tp: int) -> tuple[torch.Tensor, tuple]:
    """(out, the arguments of C entry point ``catseg_class_layer``) for one
    layer on CUDA tensors: weights cast (and in bf16 packed) as the kernel
    takes them."""
    B, T, H, W, C = x.shape
    dt = x.dtype
    # weight matrices travel in the compute dtype (bf16 feeds the tensor
    # cores, packed in mma fragment order); LN parameters and biases in
    # fp32, unrounded as in the spec
    pack = pack_mma_b if dt == torch.bfloat16 else torch.Tensor.contiguous
    w = [(pack(kp[k].to(dt)) if k.endswith("_w") else kp[k].float()).contiguous() for k in _KP]
    x = x.contiguous()
    has_guid = qg is not None
    if has_guid:
        qg, kg = qg.to(dt).contiguous(), kg.to(dt).contiguous()
    # the bf16 kernel reads class rows by 16-byte cp.async
    rows = (x, qg, kg) if has_guid else (x,)
    if any(t.data_ptr() % 16 for t in rows):
        raise ValueError(f"class layer kernel reads class rows by 16-byte copies: x, qg and kg must start 16-byte "
                         f"aligned; got addresses mod 16 {[t.data_ptr() % 16 for t in rows]}")
    out = torch.empty_like(x)
    pkv = pad_kv.float().contiguous()
    pks = pad_ksum.float().reshape(C).contiguous()
    return out, (x, out, qg, kg, pkv, pks, *w, B, T, H * W, int(has_guid), float(Tp), int(dt == torch.bfloat16))


def _class_layer_cuda(x, qg, kg, pad_kv, pad_ksum, kp: dict, Tp: int) -> torch.Tensor:
    out, args = layer_args(x, qg, kg, pad_kv, pad_ksum, kp, Tp)
    _build.launch("catseg_class_layer", *args)
    _build.count("class_layer")
    return out


def _class_layer_bwd_cuda(x, qg, kg, pad_kv, pad_ksum, dout, kp: dict, Tp: int):
    B, T, H, W, C = x.shape
    dt = x.dtype
    f32 = dict(dtype=torch.float32, device=x.device)
    # fp32 parameters, the weight matrices rounded through the compute dtype as the forward sees them
    w = [(kp[k].to(dt).float() if k.endswith("_w") else kp[k].float()).contiguous() for k in _KP]
    x, dout = x.contiguous(), dout.to(dt).contiguous()
    has_guid = qg is not None
    if has_guid:
        qg, kg = qg.to(dt).contiguous(), kg.to(dt).contiguous()
    # the bf16 backward reads dout's class rows by 16-byte cp.async
    if dout.data_ptr() % 16:
        raise ValueError(f"class layer backward reads class rows by 16-byte copies: dout must start 16-byte "
                         f"aligned; got address mod 16 {dout.data_ptr() % 16}")
    pkv = pad_kv.float().contiguous()
    pks = pad_ksum.float().reshape(C).contiguous()
    dx = torch.empty_like(x)
    dqg, dkg = (torch.empty((B, T, C), **f32) for _ in range(2)) if has_guid else (None, None)
    dpad = torch.empty(C * C + C, **f32)
    g_ln1, g_ln2 = torch.empty(2 * C, **f32), torch.empty(2 * C, **f32)
    g_qkv, g_m1, g_m2 = (torch.empty(C + 1, 3 * C, **f32), torch.empty(C + 1, 4 * C, **f32),
                         torch.empty(4 * C + 1, C, **f32))
    ws = torch.empty(_build.library().catseg_class_layer_bwd_workspace(B, T, H * W, int(dt == torch.bfloat16)),
                     **f32)
    _build.launch("catseg_class_layer_bwd", x, qg, kg, dout, pkv, pks, dx, dqg, dkg, dpad, g_ln1, g_qkv,
                  g_ln2, g_m1, g_m2, *w, ws, B, T, H * W, int(has_guid), float(Tp), int(dt == torch.bfloat16))
    _build.count("class_layer_bwd")
    grads = {"ln1_g": g_ln1[:C], "ln1_b": g_ln1[C:], "qkv_w": g_qkv[:C], "qkv_b": g_qkv[C],
             "ln2_g": g_ln2[:C], "ln2_b": g_ln2[C:], "mlp1_w": g_m1[:C], "mlp1_b": g_m1[C],
             "mlp2_w": g_m2[:4 * C], "mlp2_b": g_m2[4 * C]}
    return dx, dqg, dkg, dpad[:C * C].view(C, C), dpad[C * C:].view(1, C), grads


def class_layer_backward_plain(x, qg, kg, pad_kv, pad_ksum, dout, kp: dict, heads: int, Tp: int):
    """(dx, dqg, dkg, dpad_kv, dpad_ksum, {key: grad}) by autograd through the plain version."""
    fn = lambda x, qg, kg, pkv, pks, *ps: _plain(x, qg, kg, pkv, pks, dict(zip(_KP, ps)), heads, Tp)  # noqa: E731
    dx, dqg, dkg, dpkv, dpks, *gs = plain_vjp(fn, [x, qg, kg, pad_kv, pad_ksum, *(kp[k] for k in _KP)], dout)
    return dx, dqg, dkg, dpkv, dpks, dict(zip(_KP, gs))


def class_layer_backward(x, qg, kg, pad_kv, pad_ksum, dout, kp: dict, heads: int, Tp: int):
    """(dx, dqg, dkg, dpad_kv, dpad_ksum, {key: grad}) of one layer over the
    kernel's parameters: the CUDA kernel for CUDA tensors, the plain
    backward for CPU ones."""
    if x.is_cuda:
        _check_cuda(x, heads)
        return _class_layer_bwd_cuda(x, qg, kg, pad_kv, pad_ksum, dout, kp, Tp)
    if x.device.type != "cpu":
        raise RuntimeError(f"no class layer backward path for device {x.device}")
    return class_layer_backward_plain(x, qg, kg, pad_kv, pad_ksum, dout, kp, heads, Tp)


class _ClassLayerFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, qg, kg, pad_kv, pad_ksum, heads, Tp, *params):
        ctx.save_for_backward(x, qg, kg, pad_kv, pad_ksum, *params)
        ctx.cfg = (heads, Tp)
        kp = dict(zip(_KP, params))
        if x.is_cuda:
            return _class_layer_cuda(x, qg, kg, pad_kv, pad_ksum, kp, Tp)
        if x.device.type == "cpu":
            return _plain(x, qg, kg, pad_kv, pad_ksum, kp, heads, Tp)
        raise RuntimeError(f"no class layer path for device {x.device}")

    @staticmethod
    def backward(ctx, dout):
        x, qg, kg, pad_kv, pad_ksum, *params = ctx.saved_tensors
        dx, dqg, dkg, dpkv, dpks, g = class_layer_backward(x, qg, kg, pad_kv, pad_ksum, dout,
                                                           dict(zip(_KP, params)), *ctx.cfg)
        cast = lambda t, like: None if t is None else t.to(like.dtype)  # noqa: E731
        return (dx.to(x.dtype), cast(dqg, qg), cast(dkg, kg), cast(dpkv, pad_kv), cast(dpks, pad_ksum),
                None, None, *(cast(g[k], pr) for k, pr in zip(_KP, params)))


class_layer_op = register(
    "class_layer",
    "(Tensor x, Tensor? qg, Tensor? kg, Tensor pad_kv, Tensor pad_ksum, Tensor[] params, int heads, int Tp) -> Tensor",
    lambda x, qg, kg, pkv, pks, params, heads, Tp: _plain(x, qg, kg, pkv, pks, dict(zip(_KP, params)), heads, Tp),
    lambda x, qg, kg, pkv, pks, params, heads, Tp: _class_layer_cuda(x, qg, kg, pkv, pks, dict(zip(_KP, params)),
                                                                     Tp),
    lambda x, qg, kg, pkv, pks, params, heads, Tp: torch.empty_like(x))


def fused_class_layer(x: torch.Tensor, qg, kg, pad_kv, pad_ksum, p: dict, heads: int, Tp: int) -> torch.Tensor:
    """One class-attention layer on CLASS-major x (B, T, H, W, C), T real classes.

    qg/kg: (B, T, C) text-guidance halves of q/k, or None.  p: ln1_g/b, q_w
    (C+Cg, C), q_b, k_w, k_b, v_w (C, C), v_b, ln2_g/b, mlp1_w/b, mlp2_w/b in
    the reference's (in, out) layout.  Returns x + attention + MLP (the caller
    adds the outer residual)."""
    if x.is_cuda:
        _check_cuda(x, heads)
    kp = kernel_params(p)
    params = [kp[k] for k in _KP]
    if records_grad(x, qg, kg, pad_kv, pad_ksum, *params):
        return _ClassLayerFn.apply(x, qg, kg, pad_kv, pad_ksum, heads, Tp, *params)
    return serve(class_layer_op, "class layer", x, qg, kg, pad_kv, pad_ksum, params, heads, Tp)
