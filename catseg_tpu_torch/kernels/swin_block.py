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
softmax clamped at 60 with no max pass) on the tensor cores, its weights
handed in mma fragment order (:func:`pack_mma_b`); fp32 takes exact erf
GELU, two-pass LN and a max-subtracted softmax.  One predicate, the
activation dtype, picks the forms in the kernel and in the plain version.

Gradients: each block is a ``torch.autograd.Function``.  Its backward on
CUDA is csrc/swin_block_bwd.cu (replaces the reference's ``_bwd`` /
``_pallas_pair_bwd``; in bf16 on mma.sync tensor cores, its note there
says which operands go as bf16 and which as a hi + lo pair); on the CPU it
is autograd through the plain block, as the reference's ``_bwd_xla``.  The
pair's backward runs block 2, then block 1, each from its saved input.
Where no gradient is recorded, each block is the op
``catseg_tpu_torch::swin_block`` (``kernels/ops.py``), its parameters one
tensor list in ``_KEYS`` order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.window import window_partition, window_reverse
from . import _build
from .autograd import plain_vjp
from .layer_norm import layer_norm_fp32
from .ops import records_grad, register, serve

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


def swin_block_plain(x: torch.Tensor, qg, kg, p: dict, heads: int, win: int, shift: int) -> torch.Tensor:
    """One Swin block on x (B, T, H, W, C); qg / kg None or (B, H, W, C)."""
    B, T, H, W, C = x.shape
    dt = x.dtype
    fast = dt == torch.bfloat16
    nW = (H // win) * (W // win)
    D = C // heads

    def part(a):
        return window_partition(a.reshape(B * T, H, W, C), win).reshape(B * T, nW, win * win, heads, D)

    P = {k: p[k].float() if k.startswith("ln") else p[k].to(dt).float() for k in _KEYS}
    xf = x.reshape(B * T, H * W, C)
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
    return (xf2 + o.to(dt)).reshape(B, T, H, W, C)


def swin_pair_plain(x: torch.Tensor, guid4, p1: dict, p2: dict, heads: int, win: int) -> torch.Tensor:
    """x (B, T, H, W, C); guid4 None or (qg1, kg1, qg2, kg2) each (B, H, W, C)."""
    g = guid4 if guid4 is not None else (None,) * 4
    x = swin_block_plain(x, g[0], g[1], p1, heads, win, 0)
    return swin_block_plain(x, g[2], g[3], p2, heads, win, win // 2)


def kernel_takes(C: int, heads: int, win: int, H: int, W: int) -> bool:
    """The geometries the CUDA kernel is built for: C = 128, 4 heads,
    window 12, a grid of whole windows."""
    return (C, heads, win) == (128, 4, 12) and H % win == 0 and W % win == 0


def _check_cuda(x, heads: int, win: int) -> None:
    B, T, H, W, C = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"swin kernel takes fp32 or bf16, got {x.dtype}")
    if not kernel_takes(C, heads, win, H, W):
        raise NotImplementedError(f"swin kernel is built for C=128, 4 heads, window 12; "
                                  f"got C={C}, heads={heads}, window={win}, grid {H}x{W}")


def pack_mma_b(w: torch.Tensor, depth: int = 32) -> torch.Tensor:
    """A (K, N) weight as the bf16 kernels read their mma.m16n8k16 B
    fragments: for n8 tile j and block p of ``depth`` rows (32: two k-steps,
    16: one), lane l = 4g + t holds W[depth p + 8r + 2t + h, 8j + g] for r <
    depth / 8, h = 0..1 (b0, b1 of each k-step in turn), at element ((j K /
    depth + p) 32 + l) depth / 4; a warp reads a tile's block as 32 depth / 2
    contiguous bytes."""
    K, N = w.shape
    return w.reshape(K // depth, depth // 8, 4, 2, N // 8, 8).permute(4, 0, 5, 2, 1, 3).contiguous()


def block_args(x, qg, kg, p: dict, shift: int) -> tuple[torch.Tensor, tuple]:
    """(out, the arguments of C entry point ``catseg_swin_block``) for one
    block on CUDA tensors: weights cast and packed as the kernel takes them."""
    B, T, H, W, C = x.shape
    dt = x.dtype
    # LN parameters fp32; the rest rounded through the compute dtype, weight
    # matrices kept in it (bf16 feeds the tensor cores, in fragment order),
    # biases as fp32
    pack = pack_mma_b if dt == torch.bfloat16 else torch.Tensor.contiguous
    w = {k: (p[k].float() if k.startswith("ln") else
             pack(p[k].to(dt)) if k.endswith("_w") else p[k].to(dt).float()).contiguous() for k in _KEYS}
    x = x.contiguous()
    out = torch.empty_like(x)
    has_guid = qg is not None
    if has_guid:
        qg, kg = qg.to(dt).contiguous(), kg.to(dt).contiguous()
    # the bf16 kernel gathers token rows by 16-byte cp.async
    rows = (x, qg, kg) if has_guid else (x,)
    if any(t.data_ptr() % 16 for t in rows):
        raise ValueError(f"swin kernel reads token rows by 16-byte copies: x, qg and kg must start 16-byte "
                         f"aligned; got addresses mod 16 {[t.data_ptr() % 16 for t in rows]}")
    return out, (x, out, qg, kg, *(w[k] for k in _KEYS), B, T, H, W, shift, int(has_guid),
                 int(dt == torch.bfloat16))


def _swin_block_cuda(x, qg, kg, p: dict, shift: int) -> torch.Tensor:
    out, args = block_args(x, qg, kg, p, shift)
    _build.launch("catseg_swin_block", *args)
    _build.count("swin_block")
    return out


def _swin_block_bwd_cuda(x, qg, kg, dout, p: dict, shift: int):
    B, T, H, W, C = x.shape
    dt = x.dtype
    f32 = dict(dtype=torch.float32, device=x.device)
    # every parameter as fp32, rounded through the compute dtype as the forward sees it
    w = [(p[k].float() if k.startswith("ln") else p[k].to(dt).float()).contiguous() for k in _KEYS]
    x, dout = x.contiguous(), dout.to(dt).contiguous()
    has_guid = qg is not None
    if has_guid:
        qg, kg = qg.to(dt).contiguous(), kg.to(dt).contiguous()
    # the bf16 backward reads dout's token rows by 16-byte cp.async
    rows = (x, dout, qg, kg) if has_guid else (x, dout)
    if any(t.data_ptr() % 16 for t in rows):
        raise ValueError(f"swin backward reads token rows by 16-byte copies: x, dout, qg and kg must start "
                         f"16-byte aligned; got addresses mod 16 {[t.data_ptr() % 16 for t in rows]}")
    dx = torch.empty_like(x)
    dqg, dkg = (torch.empty((B, H, W, C), **f32) for _ in range(2)) if has_guid else (None, None)
    g_ln1, g_ln2 = torch.empty(2 * C, **f32), torch.empty(2 * C, **f32)
    g_qkv, g_proj = torch.empty(C + 1, 3 * C, **f32), torch.empty(C + 1, C, **f32)
    g_fc1, g_fc2 = torch.empty(C + 1, 4 * C, **f32), torch.empty(4 * C + 1, C, **f32)
    ws_elems = _build.library().catseg_swin_block_bwd_workspace(B, T, H, W, int(dt == torch.bfloat16))
    ws = torch.empty(ws_elems, **f32)
    _build.launch("catseg_swin_block_bwd", x, qg, kg, dout, dx, dqg, dkg, g_ln1, g_qkv, g_proj, g_ln2,
                  g_fc1, g_fc2, *w, ws, B, T, H, W, shift, int(has_guid), int(dt == torch.bfloat16))
    _build.count("swin_block_bwd")
    grads = {"ln1_g": g_ln1[:C], "ln1_b": g_ln1[C:], "qkv_w": g_qkv[:C], "qkv_b": g_qkv[C],
             "proj_w": g_proj[:C], "proj_b": g_proj[C], "ln2_g": g_ln2[:C], "ln2_b": g_ln2[C:],
             "fc1_w": g_fc1[:C], "fc1_b": g_fc1[C], "fc2_w": g_fc2[:4 * C], "fc2_b": g_fc2[4 * C]}
    return dx, dqg, dkg, grads


def swin_block_backward_plain(x, qg, kg, dout, p: dict, heads: int, win: int, shift: int):
    """(dx, dqg, dkg, {key: grad}) by autograd through the plain block."""
    fn = lambda x, qg, kg, *ps: swin_block_plain(x, qg, kg, dict(zip(_KEYS, ps)), heads, win, shift)  # noqa: E731
    dx, dqg, dkg, *gs = plain_vjp(fn, [x, qg, kg, *(p[k] for k in _KEYS)], dout)
    return dx, dqg, dkg, dict(zip(_KEYS, gs))


def swin_block_backward(x, qg, kg, dout, p: dict, heads: int, win: int, shift: int):
    """(dx, dqg, dkg, {key: grad}) of one block: the CUDA kernel for CUDA
    tensors, the plain backward for CPU ones."""
    if x.is_cuda:
        _check_cuda(x, heads, win)
        return _swin_block_bwd_cuda(x, qg, kg, dout, p, shift)
    if x.device.type != "cpu":
        raise RuntimeError(f"no swin backward path for device {x.device}")
    return swin_block_backward_plain(x, qg, kg, dout, p, heads, win, shift)


class _SwinBlockFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, qg, kg, heads, win, shift, *params):
        ctx.save_for_backward(x, qg, kg, *params)
        ctx.cfg = (heads, win, shift)
        p = dict(zip(_KEYS, params))
        if x.is_cuda:
            return _swin_block_cuda(x, qg, kg, p, shift)
        if x.device.type == "cpu":
            return swin_block_plain(x, qg, kg, p, heads, win, shift)
        raise RuntimeError(f"no swin path for device {x.device}")

    @staticmethod
    def backward(ctx, dout):
        x, qg, kg, *params = ctx.saved_tensors
        dx, dqg, dkg, g = swin_block_backward(x, qg, kg, dout, dict(zip(_KEYS, params)), *ctx.cfg)
        cast = lambda t, like: None if t is None else t.to(like.dtype)  # noqa: E731
        return (dx.to(x.dtype), cast(dqg, qg), cast(dkg, kg), None, None, None,
                *(cast(g[k], pr) for k, pr in zip(_KEYS, params)))


swin_block_op = register(
    "swin_block", "(Tensor x, Tensor? qg, Tensor? kg, Tensor[] params, int heads, int win, int shift) -> Tensor",
    lambda x, qg, kg, params, heads, win, shift: swin_block_plain(x, qg, kg, dict(zip(_KEYS, params)), heads, win,
                                                                  shift),
    lambda x, qg, kg, params, heads, win, shift: _swin_block_cuda(x, qg, kg, dict(zip(_KEYS, params)), shift),
    lambda x, qg, kg, params, heads, win, shift: torch.empty_like(x))


def _swin_block(x, qg, kg, p: dict, heads: int, win: int, shift: int) -> torch.Tensor:
    params = [p[k] for k in _KEYS]
    if records_grad(x, qg, kg, *params):
        return _SwinBlockFn.apply(x, qg, kg, heads, win, shift, *params)
    return serve(swin_block_op, "swin", x, qg, kg, params, heads, win, shift)


def fused_swin_pair(x: torch.Tensor, guid4, p1: dict, p2: dict, heads: int, win: int) -> torch.Tensor:
    """Both Swin blocks of one aggregator layer (shift 0, then win // 2)."""
    if x.is_cuda:
        _check_cuda(x, heads, win)
    g = guid4 if guid4 is not None else (None,) * 4
    x = _swin_block(x, g[0], g[1], p1, heads, win, 0)
    return _swin_block(x, g[2], g[3], p2, heads, win, win // 2)
