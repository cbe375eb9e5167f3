"""Each kernel against its plain version on the card, with the stated bounds.

``cases(device, dtype, small)`` makes seeded inputs for the six kernels of
the sliding-window path — at the slice's shapes (2 images = 10 tiles,
T = 150, pad_len 256, 1500 decoder slabs; plus the class layer at T = 256,
the count the top-k path hands it) or at small ones — and returns, per case,
a :class:`Case`: thunks (kernel, plain) that run the same call, the one
PyTorch call that computes the same function where there is one
(``library``, a yardstick the port never calls), and the work the call must
do (``flops`` of the kernel's arithmetic type, ``bytes``: each input read
once, each output written once), from which a caller bounds its time.
chip_smoke.py and tests/test_torch_cuda.py both use it.

Bounds are on max|kernel - plain| / max(1, max|plain|).  fp32: 1e-4 (the
kernels sum in another order, and use expf/erff/rsqrtf where torch has its
own).  bf16: 2^-5 (four bf16 ulps of the output's largest magnitude): both
sides round the same fp32 quantities to bf16, but a different fp32
summation order tips single roundings, and the attention kernel keeps its
probabilities in fp32 where the plain version rounds them to bf16.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from . import class_layer, clip_attn, corr_embed, decoder, layer_norm, swin_block

KERNELS = (
    # name, route, source, the TPU kernel it replaces
    ("layer_norm", "triton", "catseg_tpu_torch/kernels/layer_norm.py", "catseg_tpu/kernels/layer_norm.py:69"),
    ("dense_attention", "cuda", "catseg_tpu_torch/csrc/clip_attn.cu", "catseg_tpu/kernels/clip_attn.py:117"),
    ("corr_embed", "cuda", "catseg_tpu_torch/csrc/corr_embed.cu", "catseg_tpu/kernels/corr_embed.py:156"),
    ("swin_block", "cuda", "catseg_tpu_torch/csrc/swin_block.cu", "catseg_tpu/kernels/swin_block.py:707"),
    ("class_layer", "cuda", "catseg_tpu_torch/csrc/class_layer.cu", "catseg_tpu/kernels/class_layer.py:906"),
    ("decoder", "cuda", "catseg_tpu_torch/csrc/decoder.cu", "catseg_tpu/kernels/decoder.py:817"),
)
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}

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


def bound_ms(case: Case) -> tuple[float, str]:
    """The least time the card could take for the case's work, and what binds it."""
    t_bytes = case.bytes / HBM_BYTES_PER_S
    t_ops = case.flops / PEAK_FLOPS[case.flop_type]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts if t is not None))


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max(1, max |want|))."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


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

    # at least the 512 rows of the LayerNorm kernel's gate
    x = rn(max(B * S, 640), 768, scale=2.0).to(dtype) + 0.5
    lg, lb = 1 + un(768, bound=0.1), un(768, bound=0.1)
    out["layer_norm"] = Case(lambda: layer_norm.fused_layer_norm(x, lg, lb),
                             lambda: layer_norm.layer_norm_plain(x, lg, lb),
                             lambda: F.layer_norm(x, (768,), lg.to(dtype), lb.to(dtype)),
                             8.0 * x.numel(), 2 * _nbytes(x) + _nbytes(lg, lb), "fp32")

    q, k, v = (rn(B, S, 768).to(dtype) for _ in range(3))
    heads = lambda t: t.view(B, S, 12, 64).transpose(1, 2)  # noqa: E731
    out["dense_attention"] = Case(lambda: clip_attn.fused_dense_attention(q, k, v, 12),
                                  lambda: clip_attn.dense_attention_plain(q, k, v, 12),
                                  lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)),
                                  4.0 * B * S * S * 768, 4 * _nbytes(q), mm)

    img = rn(B, 24, 24, 512).to(dtype)
    txt = corr_embed.l2_normalize(rn(B, T, 1, 512)).to(dtype)
    cw, cb = un(7, 7, 1, 128, bound=1 / 7), un(128, bound=1 / 7)
    out["corr_embed"] = Case(lambda: corr_embed.fused_corr_embed(img, txt, cw, cb),
                             lambda: corr_embed.corr_embed_plain(img, txt, cw, cb), None,
                             2.0 * B * T * 576 * (512 + 49 * 128),
                             _nbytes(img, txt, cw, cb) + B * T * 576 * 128 * img.element_size(), mm)

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
    return out
