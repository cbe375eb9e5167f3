"""Each kernel against its plain version on the card, with the stated bounds.

``cases(device, dtype, small)`` makes seeded inputs for the six forward
kernels of the sliding-window path — at the slice's shapes (2 images = 10
tiles, T = 150, pad_len 256, 1500 decoder slabs; plus the class layer at
T = 256, the count the top-k path hands it) — for the three backward
kernels of the train step at its shapes (4 images, T = 171, pad_len 256; the
class layer on the 12x12 pooled grid; 684 decoder slabs), and for the three
kernels of the aggregator's unfused stages at the serving slab's (window
attention over its 6000 windows, also as ``window_attention@qkv`` on the strided
views of one qkv projection with no mask and as ``window_attention@w16``
over 1500 windows of 256 tokens; the ReLU class MLP of
``attention_type="full"`` at 10 x 576 positions x 256 padded classes, and
the GELU Swin MLP at its 864,000 tokens as ``mlp@swin``; linear attention
over 5760 sequences of 256 classes), and for the three forward kernels
whose shapes the larger encoder tiers change (LayerNorm rows of 1024, 1280
and 1664, dense attention at 16 heads of 64, corr embed at E 768, 1024 and
1280; ``name@shape``) — or all at small ones — and returns, per case,
a :class:`Case`: thunks (kernel, plain) that run the same call, the one
PyTorch call that computes the same function where there is one
(``library``, a yardstick the port never calls), and the work the call must
do (``flops`` of the kernel's arithmetic type, ``bytes``: each input read
once, each output written once), from which a caller bounds its time.
chip_smoke.py and tests/test_torch_cuda.py both use it.

``ROUTES`` and :func:`route_aggregator` give the aggregator at geometries
some kernels do not take (hidden width, heads, text width, window, grid),
with the kernel wrappers its routes call there and those of them whose
CUDA path refuses the geometry: the CPU tests check both sets,
chip_smoke.py [17] and tests/test_torch_cuda.py that the card raises where
one refuses, and elsewhere launches exactly the called kernels and agrees
with the CPU.

:func:`recorded_calls` records every call the port makes to a forward
kernel's wrapper while a path runs, and :func:`check_calls` holds each
recorded call's kernel against its plain version (``FORWARD_PAIRS``) on the
same inputs: chip_smoke.py [15] checks the whole-image branch's kernels at
the very shapes and values that path hands them.

A backward case's thunks return a dict of every gradient it produces (dx,
the guidance or pad cotangents, each parameter's); the plain version there is
autograd through the plain forward on the same device.

Bounds: a forward output on max|kernel - plain| / max(1, max|plain|); each
gradient on the relative Frobenius error |kernel - plain| / |plain|.  A
max-norm says nothing about gradients: where a ReLU's input is within the
last bits of zero (class-layer MLP, every decoder GroupNorm), the two
recomputes can put it on opposite sides, and that element's gradient flips
between 0 and its full value (:func:`max_rel` reads the max-norm error, for
the log).  Forward fp32: 1e-4 (the kernels sum in another order, and use
expf/erff/rsqrtf where torch has its own); bf16 2^-5.  Gradients, fp32: one
bound per kernel, between its sound fp32 reading and its bf16 one at the
train shapes (chip_smoke.py phase [3], H100 80GB HBM3, 700 W), so that a
backward that rounded through bf16 or TF32 fails: swin 1e-4 (read 2.1e-6
fp32, 4.1e-3 bf16), class layer 1e-3 (2.8e-4, 2.2e-3), decoder 3e-3
(1.2e-3, the ReLU flips; 2.0e-2); bf16 2^-5."""

from __future__ import annotations

import contextlib
import sys
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from . import class_layer, clip_attn, corr_embed, decoder, layer_norm, linear_attn, mlp, swin_block, window_attn

KERNELS = (
    # name, route, source, the TPU kernel it replaces
    ("layer_norm", "cuda", "catseg_tpu_torch/csrc/layer_norm.cu", "catseg_tpu/kernels/layer_norm.py:69"),
    ("dense_attention", "cuda", "catseg_tpu_torch/csrc/clip_attn.cu", "catseg_tpu/kernels/clip_attn.py:117"),
    ("corr_embed", "cuda", "catseg_tpu_torch/csrc/corr_embed.cu", "catseg_tpu/kernels/corr_embed.py:156"),
    ("swin_block", "cuda", "catseg_tpu_torch/csrc/swin_block.cu", "catseg_tpu/kernels/swin_block.py:707"),
    ("class_layer", "cuda", "catseg_tpu_torch/csrc/class_layer.cu", "catseg_tpu/kernels/class_layer.py:906"),
    ("decoder", "cuda", "catseg_tpu_torch/csrc/decoder.cu", "catseg_tpu/kernels/decoder.py:817"),
    ("swin_block_bwd", "cuda", "catseg_tpu_torch/csrc/swin_block_bwd.cu", "catseg_tpu/kernels/swin_block.py:737"),
    ("class_layer_bwd", "cuda", "catseg_tpu_torch/csrc/class_layer_bwd.cu", "catseg_tpu/kernels/class_layer.py:924"),
    ("decoder_bwd", "cuda", "catseg_tpu_torch/csrc/decoder_bwd.cu", "catseg_tpu/kernels/decoder.py:904"),
    ("window_attention", "cuda", "catseg_tpu_torch/csrc/window_attn.cu", "catseg_tpu/kernels/window_attn.py:96"),
    ("mlp", "cuda", "catseg_tpu_torch/csrc/mlp.cu", "catseg_tpu/kernels/mlp.py:159"),
    ("linear_attention", "cuda", "catseg_tpu_torch/csrc/linear_attn.cu", "catseg_tpu/kernels/linear_attn.py:100"),
)
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}
BOUND_GRAD_FP32 = {"swin_block_bwd": 1e-4, "class_layer_bwd": 1e-3, "decoder_bwd": 3e-3}


def bound(name: str, dtype: torch.dtype) -> float:
    """The stated bound of a case (the backward cases' are on gradients)."""
    if dtype == torch.float32 and name in BOUND_GRAD_FP32:
        return BOUND_GRAD_FP32[name]
    return BOUND[dtype]

# H100 SXM published peaks (dense): device memory, bf16 tensor cores, fp32 CUDA cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16_tc": 989e12, "fp32": 67e12}


class Case(NamedTuple):
    kernel: Callable
    plain: Callable
    library: Callable | None
    flops: float      # multiply-adds count 2
    bytes: float
    flop_type: str    # key of PEAK_FLOPS the kernel's arithmetic runs at
    # (kernel, library) thunks over fresh copies of the inputs, for a timing
    # loop that must rotate over more bytes than the L2 holds (the bound
    # counts device-memory bytes); None where one call's inputs exceed it
    fresh: Callable | None = None


def bound_ms(case: Case) -> tuple[float, str]:
    """The least time the card could take for the case's work, and what binds it."""
    t_bytes = case.bytes / HBM_BYTES_PER_S
    t_ops = case.flops / PEAK_FLOPS[case.flop_type]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts if t is not None))


def rel_err(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max(1, max |want|)) of a tensor; of a
    dict of gradients, (the largest max abs error, the largest relative
    Frobenius error |got - want| / |want|) over its entries."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"gradients {sorted(got)} != {sorted(want)}")
        errs = [((got[k].float() - want[k].float()).abs().max().item(),
                 ((got[k].float() - want[k].float()).norm() / want[k].float().norm().clamp_min(1e-30)).item())
                for k in want]
        return max(e for e, _ in errs), max(r for _, r in errs)
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


def max_rel(got: dict, want: dict) -> tuple[float, str]:
    """The largest max|got - want| / max|want| over a dict's gradients, and its key."""
    return max(((got[k].float() - want[k].float()).abs().max().item()
                / max(want[k].float().abs().max().item(), 1e-30), k) for k in want)


def _grads(names, res) -> dict:
    """A backward's (tensors..., {param: grad}) as one flat dict, Nones dropped."""
    *ts, g = res
    out = {n: t for n, t in zip(names, ts) if t is not None}
    out.update({f"d{k}": v for k, v in g.items()})
    return out


def cases(device, dtype: torch.dtype, small: bool = False) -> dict[str, Case]:
    g = torch.Generator(device="cpu").manual_seed(0)
    mm = "bf16_tc" if dtype == torch.bfloat16 else "fp32"

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(device)

    def un(*shape, bound=None):
        bound = shape[0] ** -0.5 if bound is None else bound
        return ((torch.rand(*shape, generator=g) * 2 - 1) * bound).to(device)

    B, T, S = (1, 3, 65) if small else (10, 150, 577)
    out = {}

    def ln_case(width):
        x = rn(max(B * S, 640), width, scale=2.0).to(dtype) + 0.5
        lg, lb = 1 + un(width, bound=0.1), un(width, bound=0.1)
        lgd, lbd = lg.to(dtype), lb.to(dtype)

        def calls(x):
            return (lambda: layer_norm.fused_layer_norm(x, lg, lb), lambda: F.layer_norm(x, (width,), lgd, lbd))

        kern, lib = calls(x)
        return Case(kern, lambda: layer_norm.layer_norm_plain(x, lg, lb), lib, 8.0 * x.numel(),
                    2 * _nbytes(x) + _nbytes(lg, lb), "fp32", fresh=lambda: calls(x.clone()))

    def attn_case(width, n_heads):
        q, k, v = (rn(B, S, width).to(dtype) for _ in range(3))
        heads = lambda t: t.view(B, S, n_heads, 64).transpose(1, 2)  # noqa: E731

        def calls(q, k, v):
            return (lambda: clip_attn.fused_dense_attention(q, k, v, n_heads),
                    lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)))

        kern, lib = calls(q, k, v)
        return Case(kern, lambda: clip_attn.dense_attention_plain(q, k, v, n_heads), lib,
                    4.0 * B * S * S * width, 4 * _nbytes(q), mm, fresh=lambda: calls(q.clone(), k.clone(), v.clone()))

    def corr_case(E):
        img = rn(B, 24, 24, E).to(dtype)
        txt = corr_embed.l2_normalize(rn(B, T, 1, E)).to(dtype)
        cw, cb = un(7, 7, 1, 128, bound=1 / 7), un(128, bound=1 / 7)
        return Case(lambda: corr_embed.fused_corr_embed(img, txt, cw, cb),
                    lambda: corr_embed.corr_embed_plain(img, txt, cw, cb), None,
                    2.0 * B * T * 576 * (E + 49 * 128),
                    _nbytes(img, txt, cw, cb) + B * T * 576 * 128 * img.element_size(), mm)

    out["layer_norm"] = ln_case(768)
    out["dense_attention"] = attn_case(768, 12)
    out["corr_embed"] = corr_case(512)

    def swin_params():
        C = 128
        return {"ln1_g": 1 + un(C, bound=0.1), "ln1_b": un(C, bound=0.1), "qkv_w": un(C, 3 * C),
                "qkv_b": un(3 * C, bound=0.1), "proj_w": un(C, C), "proj_b": un(C, bound=0.1),
                "ln2_g": 1 + un(C, bound=0.1), "ln2_b": un(C, bound=0.1), "fc1_w": un(C, 4 * C),
                "fc1_b": un(4 * C, bound=0.1), "fc2_w": un(4 * C, C), "fc2_b": un(C, bound=0.1)}

    xs = rn(B, T, 24, 24, 128).to(dtype)
    guid4 = tuple(rn(B, 24, 24, 128, scale=0.5).to(dtype) for _ in range(4))
    p1, p2 = swin_params(), swin_params()
    out["swin_block"] = Case(lambda: swin_block.fused_swin_pair(xs, guid4, p1, p2, 4, 12),
                             lambda: swin_block.swin_pair_plain(xs, guid4, p1, p2, 4, 12), None,
                             2 * 2.0 * xs.numel() / 128 * (12 * 128 * 128 + 2 * 144 * 128),
                             2 * _nbytes(xs) + _nbytes(*guid4), mm)

    C, Tp = 128, (8 if small else 256)
    cp = {"ln1_g": 1 + un(C, bound=0.1), "ln1_b": un(C, bound=0.1), "q_w": un(2 * C, C), "q_b": un(C),
          "k_w": un(2 * C, C), "k_b": un(C), "v_w": un(C, C), "v_b": un(C),
          "ln2_g": 1 + un(C, bound=0.1), "ln2_b": un(C, bound=0.1), "mlp1_w": un(C, 4 * C),
          "mlp1_b": un(4 * C), "mlp2_w": un(4 * C, C), "mlp2_b": un(C)}
    def class_case(Tc):
        xc = rn(B, Tc, 24, 24, C).to(dtype)
        qg, kg = rn(B, Tc, C, scale=0.3).to(dtype), rn(B, Tc, C, scale=0.3).to(dtype)
        pkv, pks = class_layer.pad_contributions(rn(C), rn(C), cp, Tp - Tc, Tp, 4)
        rows = xc.numel() / C
        return Case(lambda: class_layer.fused_class_layer(xc, qg, kg, pkv, pks, cp, 4, Tp),
                    lambda: class_layer.class_layer_plain(xc, qg, kg, pkv, pks, cp, 4, Tp), None,
                    2.0 * rows * (11 * C * C + 2 * C * 32), 2 * _nbytes(xc) + _nbytes(qg, kg), mm)

    out["class_layer"] = class_case(T)
    if not small:   # the top-k path's full pad_len
        out["class_layer@T256"] = class_case(Tp)

    # the decoder: Up(128 -> 96, guidance 32 -> mid 64), Up(64 -> 48, guidance 16 -> mid 32), head
    Bd, Td = (1, 3) if small else (B, T)

    def up(cin, cup, mid):
        return {"up_w": un(cin, cup, 2, 2, bound=(4 * cin) ** -0.5), "up_b": un(cup, bound=0.05),
                "conv1_w": un(mid, cin, 3, 3, bound=(9 * cin) ** -0.5),
                "gn1_g": 1 + un(mid, bound=0.1), "gn1_b": un(mid, bound=0.1),
                "conv2_w": un(mid, mid, 3, 3, bound=(9 * mid) ** -0.5),
                "gn2_g": 1 + un(mid, bound=0.1), "gn2_b": un(mid, bound=0.1)}

    d1, d2 = up(128, 96, 64), up(64, 48, 32)
    head = {"w": un(1, 32, 3, 3, bound=(9 * 32) ** -0.5), "b": un(1, bound=0.1)}
    xd = rn(Bd * Td, 24, 24, 128).to(dtype)
    g1, g2 = rn(Bd, 48, 48, 32, scale=0.5).to(dtype), rn(Bd, 96, 96, 16, scale=0.5).to(dtype)
    slab_flops = 2.0 * (576 * 128 * 384 + 2304 * 864 * 64 + 2304 * 576 * 64 + 2304 * 64 * 192
                        + 9216 * 432 * 32 + 9216 * 288 * 32 + 9216 * 288)
    out["decoder"] = Case(lambda: decoder.fused_decoder(xd, g1, g2, d1, d2, head),
                          lambda: decoder.decoder_plain(xd, g1, g2, d1, d2, head), None,
                          slab_flops * Bd * Td,
                          _nbytes(xd) + Bd * (48 * 48 * 64 + 96 * 96 * 32) * xd.element_size()
                          + Bd * Td * 96 * 96 * 4, mm)

    # backward kernels at the train step's shapes.  Work: the recompute of
    # the forward plus two products (input and weight gradient) per forward
    # product, 3x the forward's operations; bytes: inputs and dout read once,
    # every gradient written once.
    Bt, Tt = (1, 3) if small else (4, 171)
    xb = rn(Bt, Tt, 24, 24, 128).to(dtype)
    gb = tuple(rn(Bt, 24, 24, 128, scale=0.5).to(dtype) for _ in range(2))
    db = rn(Bt, Tt, 24, 24, 128).to(dtype)
    pb = swin_params()
    swin_names = ("dx", "dqg", "dkg")
    out["swin_block_bwd"] = Case(
        lambda: _grads(swin_names, swin_block.swin_block_backward(xb, *gb, db, pb, 4, 12, 6)),
        lambda: _grads(swin_names, swin_block.swin_block_backward_plain(xb, *gb, db, pb, 4, 12, 6)), None,
        3 * 2.0 * xb.numel() / 128 * (12 * 128 * 128 + 2 * 144 * 128),
        _nbytes(xb, db, *gb) + _nbytes(xb) + 2 * Bt * 576 * 128 * 4 + 4 * (12 * 128 * 128 + 14 * 128), mm)

    Tpb = 8 if small else 256
    xc = rn(Bt, Tt, 12, 12, C).to(dtype)
    qc, kc = rn(Bt, Tt, C, scale=0.3).to(dtype), rn(Bt, Tt, C, scale=0.3).to(dtype)
    pkv, pks = class_layer.pad_contributions(rn(C), rn(C), cp, Tpb - Tt, Tpb, 4)
    dc = rn(Bt, Tt, 12, 12, C).to(dtype)
    kp = class_layer.kernel_params(cp)
    cl_names = ("dx", "dqg", "dkg", "dpad_kv", "dpad_ksum")
    out["class_layer_bwd"] = Case(
        lambda: _grads(cl_names, class_layer.class_layer_backward(xc, qc, kc, pkv, pks, dc, kp, 4, Tpb)),
        lambda: _grads(cl_names, class_layer.class_layer_backward_plain(xc, qc, kc, pkv, pks, dc, kp, 4, Tpb)),
        None, 3 * 2.0 * xc.numel() / C * (11 * C * C + 2 * C * 32),
        _nbytes(xc, dc, qc, kc) + _nbytes(xc) + 2 * qc.numel() * 4 + 4 * (11 * C * C + C * C), mm)

    Nd = Bt * Tt
    xdb = rn(Nd, 24, 24, 128).to(dtype)
    dp = dict(zip(decoder._DK, decoder._params(d1, d2, head)))
    hg1 = decoder._guidance_half(d1, rn(Bt, 48, 48, 32, scale=0.5), 96, dtype)
    hg2 = decoder._guidance_half(d2, rn(Bt, 96, 96, 16, scale=0.5), 48, dtype)
    ddb = rn(Nd, 96, 96)
    dec_names = ("dx", "dhg1", "dhg2")
    out["decoder_bwd"] = Case(
        lambda: _grads(dec_names, decoder.decoder_backward(xdb, hg1, hg2, ddb, dp)),
        lambda: _grads(dec_names, decoder.decoder_backward_plain(xdb, hg1, hg2, ddb, dp)), None,
        3 * slab_flops * Nd,
        2 * _nbytes(xdb) + _nbytes(hg1, hg2, ddb) + 4 * (hg1.numel() + hg2.numel()), mm)

    # the unfused stages' kernels
    Bw = 8 if small else B * T * 4
    qw, kw, vw = (rn(Bw, 144, 128).to(dtype) for _ in range(3))
    mask = swin_block.shift_mask(24, 24, 12, 6).to(device)
    lib_mask = mask.to(dtype).repeat(Bw // 4, 1, 1)[:, None]
    wheads = lambda t: t.view(Bw, 144, 4, 32).transpose(1, 2)  # noqa: E731
    out["window_attention"] = Case(
        lambda: window_attn.fused_window_attention(qw, kw, vw, mask, 4, 32 ** -0.5),
        lambda: window_attn.window_attention_plain(qw, kw, vw, mask, 4, 32 ** -0.5),
        lambda: F.scaled_dot_product_attention(wheads(qw), wheads(kw), wheads(vw), attn_mask=lib_mask,
                                               scale=32 ** -0.5),
        4.0 * Bw * 144 * 144 * 128, 4 * _nbytes(qw) + _nbytes(mask), mm)
    # as the unfused Swin block's unshifted half calls it: views of one fused
    # qkv projection (rows 3C apart), no mask
    qs, ks, vs = rn(Bw, 144, 384).to(dtype).split(128, dim=-1)
    out["window_attention@qkv"] = Case(
        lambda: window_attn.fused_window_attention(qs, ks, vs, None, 4, 32 ** -0.5),
        lambda: window_attn.window_attention_plain(qs, ks, vs, None, 4, 32 ** -0.5),
        lambda: F.scaled_dot_product_attention(wheads(qs), wheads(ks), wheads(vs), scale=32 ** -0.5),
        4.0 * Bw * 144 * 144 * 128, 4 * _nbytes(qw), mm)
    # window 16 (256 tokens, the most the kernel takes; 32 x 32 grids, 4
    # windows each): bf16 takes the tensor cores in two 128-key halves
    Bw16 = 8 if small else 1500
    q16, k16, v16 = (rn(Bw16, 256, 128).to(dtype) for _ in range(3))
    mask16 = swin_block.shift_mask(32, 32, 16, 8).to(device)
    heads16 = lambda t: t.view(Bw16, 256, 4, 32).transpose(1, 2)  # noqa: E731
    out["window_attention@w16"] = Case(
        lambda: window_attn.fused_window_attention(q16, k16, v16, mask16, 4, 32 ** -0.5),
        lambda: window_attn.window_attention_plain(q16, k16, v16, mask16, 4, 32 ** -0.5),
        lambda: F.scaled_dot_product_attention(heads16(q16), heads16(k16), heads16(v16),
                                               attn_mask=mask16.to(dtype).repeat(Bw16 // 4, 1, 1)[:, None],
                                               scale=32 ** -0.5),
        4.0 * Bw16 * 256 * 256 * 128, 4 * _nbytes(q16) + _nbytes(mask16), mm)

    def mlp_case(M, act):
        xm = rn(M, C).to(dtype)
        w1, b1, w2, b2 = un(C, 4 * C), un(4 * C), un(4 * C, C), un(C)
        return Case(lambda: mlp.fused_mlp(xm, w1, b1, w2, b2, act),
                    lambda: mlp.mlp_plain(xm, w1, b1, w2, b2, act), None,
                    4.0 * M * C * 4 * C, 2 * _nbytes(xm) + _nbytes(w1, w2) * xm.element_size() / 4, mm)

    out["mlp"] = mlp_case(1324 if small else B * 576 * 256, "relu")   # a ragged last tile when small
    out["mlp@swin"] = mlp_case(1024 if small else B * T * 576, "gelu")

    Nl, Sl = (16, 16) if small else (B * 576, 256)
    ql, kl, vl = (rn(Nl, Sl, C).to(dtype) for _ in range(3))
    # the spec's fp32 operations, Q.KV and KV at D = 32, in both dtypes (the
    # kernel runs them as three bf16 products on the tensor cores); bytes bind
    out["linear_attention"] = Case(lambda: linear_attn.fused_linear_attention(ql, kl, vl, 4),
                                   lambda: linear_attn.linear_attention_plain(ql, kl, vl, 4), None,
                                   4.0 * Nl * Sl * C * 32, 4 * _nbytes(ql), "fp32")

    # the larger encoder tiers' shapes: ViT-L/14 (L), ViT-H-14 (H), ViT-bigG-14
    # (G); drawn last, so the cases above keep their inputs
    if not small:
        for width in (1024, 1280, 1664):   # visual rows of L, H, G; text rows 768 / 1024 / 1280
            out[f"layer_norm@{width}"] = ln_case(width)
        out["dense_attention@16h"] = attn_case(1024, 16)   # L; H and G (head dims 80, 104) take no kernel
        for E in (768, 1024, 1280):   # the embed width of L, H, G
            out[f"corr_embed@E{E}"] = corr_case(E)
    return out


# name: (hidden, heads, text width E, window, grid, pooling, attention type,
#        the kernel wrappers the aggregator's routes call at that geometry,
#        those of them whose kernel does not take it: the card raises there)
ROUTES = {
    "flagship": (128, 4, 64, 12, 24, (1, 1), "linear", {"corr_embed", "swin_block", "class_layer", "decoder"}, set()),
    "E48 pool2": (128, 4, 48, 12, 24, (2, 2), "linear", {"corr_embed", "swin_block", "class_layer", "decoder"},
                  {"corr_embed"}),
    "heads1": (128, 1, 64, 12, 24, (1, 1), "linear",
               {"corr_embed", "window_attention", "mlp", "linear_attention", "decoder"},
               {"window_attention", "linear_attention"}),
    "hidden256": (256, 4, 64, 12, 24, (1, 1), "linear", {"corr_embed", "window_attention", "mlp", "linear_attention"},
                  {"corr_embed"}),
    "hidden256 E40 full": (256, 4, 40, 12, 24, (2, 2), "full", {"corr_embed", "window_attention", "mlp"},
                           {"corr_embed"}),
    "hidden512": (512, 4, 64, 12, 24, (1, 1), "linear", {"corr_embed", "window_attention", "mlp", "linear_attention"},
                  {"corr_embed", "window_attention", "mlp", "linear_attention"}),
    "hidden96": (96, 4, 64, 12, 24, (1, 1), "linear", {"window_attention", "mlp", "linear_attention"},
                 {"window_attention", "mlp", "linear_attention"}),
    "hidden32 win4": (32, 4, 48, 4, 8, (2, 2), "linear", {"window_attention", "mlp", "linear_attention"}, set()),
    "hidden64 heads8 E24": (64, 8, 24, 4, 8, (1, 1), "linear", {"window_attention", "mlp", "linear_attention"},
                            set()),
}


def route_aggregator(name: str, T: int = 8, seed: int = 0):
    """(cfg, aggregator, (img_feats, text_feats, guidance)) for ``ROUTES[name]``:
    an fp32 eval config (pad_len 8, 2 layers), seeded weights (LN gains near
    1, the rest U(+-1/sqrt(fan_in))) and seeded inputs (one image, T classes,
    P = 1), all on the CPU."""
    from ..configs import CATSegConfig
    from ..core.aggregator import Aggregator

    C, heads, E, win, grid, pool, attn, _, _ = ROUTES[name]
    dec = dict(decoder_dims=(64, 32), decoder_guidance_dims=(64, 32), decoder_guidance_proj_dims=(32, 16))
    if C < 64:
        dec = dict(decoder_dims=(32, 16), decoder_guidance_dims=(24, 12), decoder_guidance_proj_dims=(8, 4))
    cfg = CATSegConfig(hidden_dim=C, num_heads=heads, window_size=win, feature_resolution=(grid, grid),
                       pooling_size=pool, attention_type=attn, pad_len=8, num_layers=2, compute_dtype="float32",
                       text_guidance_dim=E, text_guidance_proj_dim=32, appearance_guidance_dim=E,
                       appearance_guidance_proj_dim=32, sliding_window=True, **dec)
    agg = Aggregator(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for pname, p in agg.named_parameters():
            u = torch.rand(p.shape, generator=g) * 2 - 1
            if pname.endswith(("norm1.weight", "norm2.weight", "norm.weight")):
                p.copy_(1 + 0.1 * u)
            else:
                p.copy_(u * (p[0].numel() if p.ndim > 1 else p.numel()) ** -0.5)
    img = torch.randn(1, grid, grid, E, generator=g)
    txt = torch.randn(1, T, 1, E, generator=g)
    d1, d2 = cfg.decoder_guidance_dims
    guid = (torch.randn(1, grid, grid, E, generator=g), torch.randn(1, 2 * grid, 2 * grid, d1, generator=g),
            torch.randn(1, 4 * grid, 4 * grid, d2, generator=g))
    return cfg, agg.eval(), (img, txt, guid)


# each forward kernel's wrapper and its plain version, called alike
FORWARD_PAIRS = {
    "layer_norm": (layer_norm.fused_layer_norm, layer_norm.layer_norm_plain),
    "dense_attention": (clip_attn.fused_dense_attention, clip_attn.dense_attention_plain),
    "corr_embed": (corr_embed.fused_corr_embed, corr_embed.corr_embed_plain),
    "swin_block": (swin_block.fused_swin_pair, swin_block.swin_pair_plain),
    "class_layer": (class_layer.fused_class_layer, class_layer.class_layer_plain),
    "decoder": (decoder.fused_decoder, decoder.decoder_plain),
}


def _cloned(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    return type(a)(_cloned(t) for t in a) if isinstance(a, (tuple, list)) else a


@contextlib.contextmanager
def recorded_calls():
    """Yields a list that receives ``(name, args)`` for every call any module
    of the port makes to a ``FORWARD_PAIRS`` wrapper inside the block, its
    tensors cloned; the wrappers run as ever and are restored on exit."""
    calls, patched = [], []
    for name, (wrapper, _) in FORWARD_PAIRS.items():
        def record(*a, _name=name, _wrapper=wrapper):
            calls.append((_name, _cloned(a)))
            return _wrapper(*a)
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("catseg_tpu_torch"):
                for attr, val in list(vars(mod).items()):
                    if val is wrapper:
                        patched.append((mod, attr, val))
                        setattr(mod, attr, record)
    try:
        yield calls
    finally:
        for mod, attr, val in patched:
            setattr(mod, attr, val)


def check_calls(calls, dtype: torch.dtype) -> dict[str, tuple[int, float, float]]:
    """{name: (calls, worst max abs error, worst error / max(1, max |plain|))}
    of recorded calls, each kernel call against its plain version on the
    same inputs; the caller judges the second against :func:`bound`."""
    out = {}
    with torch.inference_mode():
        for name, args in calls:
            wrapper, plain = FORWARD_PAIRS[name]
            err, rel = rel_err(wrapper(*args), plain(*args))
            n, e0, r0 = out.get(name, (0, 0.0, 0.0))
            out[name] = (n + 1, max(e0, err), max(r0, rel))
    return out
