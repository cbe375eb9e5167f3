"""Each kernel against its plain version on the card, with the stated bounds.

``cases(device, dtype, small)`` makes seeded inputs for the five kernels of
the sliding-window path — at the slice's shapes (2 images = 10 tiles,
T = 150, pad_len 256) or at small ones — and returns, per kernel, a pair of
thunks (kernel, plain) that run the same call.  chip_smoke.py and
tests/test_torch_cuda.py both use it.

Bounds are on max|kernel - plain| / max(1, max|plain|).  fp32: 1e-4 (the
kernels sum in another order, and use expf/erff/rsqrtf where torch has its
own).  bf16: 2^-5 (four bf16 ulps of the output's largest magnitude): both
sides round the same fp32 quantities to bf16, but a different fp32
summation order tips single roundings, and the attention kernel keeps its
probabilities in fp32 where the plain version rounds them to bf16.
"""

from __future__ import annotations

import torch

from . import class_layer, clip_attn, corr_embed, layer_norm, swin_block

KERNELS = (
    # name, route, source, the TPU kernel it replaces
    ("layer_norm", "triton", "catseg_tpu_torch/kernels/layer_norm.py", "catseg_tpu/kernels/layer_norm.py:69"),
    ("dense_attention", "cuda", "catseg_tpu_torch/csrc/clip_attn.cu", "catseg_tpu/kernels/clip_attn.py:117"),
    ("corr_embed", "cuda", "catseg_tpu_torch/csrc/corr_embed.cu", "catseg_tpu/kernels/corr_embed.py:156"),
    ("swin_block", "cuda", "catseg_tpu_torch/csrc/swin_block.cu", "catseg_tpu/kernels/swin_block.py:707"),
    ("class_layer", "cuda", "catseg_tpu_torch/csrc/class_layer.cu", "catseg_tpu/kernels/class_layer.py:906"),
)
BOUND = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max(1, max |want|))."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


def cases(device, dtype: torch.dtype, small: bool = False) -> dict:
    g = torch.Generator(device="cpu").manual_seed(0)

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
    out["layer_norm"] = (lambda: layer_norm.fused_layer_norm(x, lg, lb),
                         lambda: layer_norm.layer_norm_plain(x, lg, lb))

    q, k, v = (rn(B, S, 768).to(dtype) for _ in range(3))
    out["dense_attention"] = (lambda: clip_attn.fused_dense_attention(q, k, v, 12),
                              lambda: clip_attn.dense_attention_plain(q, k, v, 12))

    img = rn(B, 24, 24, 512).to(dtype)
    txt = corr_embed.l2_normalize(rn(B, T, 1, 512)).to(dtype)
    cw, cb = un(7, 7, 1, 128, bound=1 / 7), un(128, bound=1 / 7)
    out["corr_embed"] = (lambda: corr_embed.fused_corr_embed(img, txt, cw, cb),
                         lambda: corr_embed.corr_embed_plain(img, txt, cw, cb))

    def swin_params():
        C = 128
        return {"ln1_g": 1 + un(C, bound=0.1), "ln1_b": un(C, bound=0.1), "qkv_w": un(C, 3 * C),
                "qkv_b": un(3 * C, bound=0.1), "proj_w": un(C, C), "proj_b": un(C, bound=0.1),
                "ln2_g": 1 + un(C, bound=0.1), "ln2_b": un(C, bound=0.1), "fc1_w": un(C, 4 * C),
                "fc1_b": un(4 * C, bound=0.1), "fc2_w": un(4 * C, C), "fc2_b": un(C, bound=0.1)}

    xs = rn(B, T, 24, 24, 128).to(dtype)
    guid4 = tuple(rn(B, 24, 24, 128, scale=0.5).to(dtype) for _ in range(4))
    p1, p2 = swin_params(), swin_params()
    out["swin_block"] = (lambda: swin_block.fused_swin_pair(xs, guid4, p1, p2, 4, 12),
                         lambda: swin_block.swin_pair_plain(xs, guid4, p1, p2, 4, 12))

    C, Tp = 128, (8 if small else 256)
    cp = {"ln1_g": 1 + un(C, bound=0.1), "ln1_b": un(C, bound=0.1), "q_w": un(2 * C, C), "q_b": un(C),
          "k_w": un(2 * C, C), "k_b": un(C), "v_w": un(C, C), "v_b": un(C),
          "ln2_g": 1 + un(C, bound=0.1), "ln2_b": un(C, bound=0.1), "mlp1_w": un(C, 4 * C),
          "mlp1_b": un(4 * C), "mlp2_w": un(4 * C, C), "mlp2_b": un(C)}
    xc = rn(B, T, 24, 24, C).to(dtype)
    qg, kg = rn(B, T, C, scale=0.3).to(dtype), rn(B, T, C, scale=0.3).to(dtype)
    pkv, pks = class_layer.pad_contributions(rn(C), rn(C), cp, Tp - T, Tp, 4)
    out["class_layer"] = (lambda: class_layer.fused_class_layer(xc, qg, kg, pkv, pks, cp, 4, Tp),
                          lambda: class_layer.class_layer_plain(xc, qg, kg, pkv, pks, cp, 4, Tp))
    return out
