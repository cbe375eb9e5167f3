"""The order of arithmetic of the bf16 class-layer kernel, on the CPU.

csrc/class_layer.cu's tensor-core kernel keeps the spec's rounding points
(LN1 and LN2 outputs, seq = x + attention, the ReLU hidden layer and the fc2
output are rounded to bf16; q, k, v, the linear attention and its
normaliser stay fp32), but sums in its own order: KV = K^T V and the K sum
over every 8th class row in 8 partial sums, met by an xor butterfly
(lane 0 ends with ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7))), then
the padding rows' terms; z = Q.Ksum and Q.KV as fused multiply-adds over d
in order.  The kernel runs only on the card; here a plain-PyTorch mirror of
that order, kept in this file, is held to catseg_tpu's ``_reference`` in
bf16 within 2^-5 of max(1, |ref|), the kernel's own bound against the plain
version (chip_smoke [3]).  The decoder kernel (csrc/decoder.cu) rounds where
it did before and changed only the order of its fp32 GroupNorm sums; its
bit-equal reruns are checked on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catseg_tpu.kernels import class_layer as jcl

from catseg_tpu_torch.kernels import class_layer as tcl

BOUND = 2.0 ** -5


def _fma(a, b, c):
    """fp32 fused multiply-add: the product is exact in fp64, then one rounding."""
    return (a.double() * b.double() + c.double()).float()


def _ln(x, g, b):
    """the kernel's bf16 LayerNorm: single-pass variance, fp32 statistics, rounded"""
    mean = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mean * mean
    return ((x - mean) * torch.rsqrt(var + 1e-5) * g + b).to(torch.bfloat16).float()


def _phase_sum(v):
    """sum over dim 0 as the kernel's KV reduction: 8 row phases summed in row
    order, then the butterfly over the phases"""
    parts = [torch.zeros_like(v[0]) for _ in range(8)]
    for t in range(v.shape[0]):
        parts[t % 8] = parts[t % 8] + v[t]
    for o in (1, 2, 4):
        parts = [parts[s] + parts[s ^ o] for s in range(8)]
    return parts[0]


def kernel_order(x, qg, kg, pad_kv, pad_ksum, kp, heads, Tp):
    """One position's layer in the kernel's order: x (T, C) bf16-valued fp32,
    qg / kg (T, C) or None, kp the kernel's parameters (kernel_params)."""
    T, C = x.shape
    D = C // heads
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    y = _ln(x, kp["ln1_g"], kp["ln1_b"])
    qkv = y @ bf(kp["qkv_w"]) + kp["qkv_b"]
    q, k, v = qkv[:, :C], qkv[:, C:2 * C], qkv[:, 2 * C:]
    if qg is not None:
        q, k = q + qg, k + kg
    elu1 = lambda t: torch.where(t > 0, t + 1.0, torch.exp(t.clamp_max(0.0)))  # noqa: E731
    Q, K, V = elu1(q), elu1(k), v / Tp
    seq = torch.empty_like(x)
    for h in range(heads):
        s = slice(h * D, (h + 1) * D)
        kv = _phase_sum(K[:, s, None] * V[:, None, s]) + pad_kv[s, s]
        ks = _phase_sum(K[:, s]) + pad_ksum.reshape(C)[s]
        z = torch.zeros(T)
        o = torch.zeros(T, D)
        for d in range(D):
            z = _fma(Q[:, h * D + d], ks[d].expand(T), z)
            o = _fma(Q[:, h * D + d, None].expand(T, D), kv[d][None].expand(T, D), o)
        seq[:, s] = bf(x[:, s] + o * (Tp / (z + 1e-6))[:, None])
    y2 = _ln(seq, kp["ln2_g"], kp["ln2_b"])
    hid = bf(torch.relu(y2 @ bf(kp["mlp1_w"]) + kp["mlp1_b"]))
    return bf(seq + bf(hid @ bf(kp["mlp2_w"]) + kp["mlp2_b"]))


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("T", [5, 20])
def test_class_kernel_order_matches_reference(T, guided):
    """2 x 2 positions of T classes (T = 20 fills every row phase more than
    twice), pad_len 32, against catseg_tpu's _reference in bf16."""
    rng = np.random.RandomState(T + 7 * guided)
    C, heads, Tp = 128, 4, 32
    u = lambda *s: rng.uniform(-s[0] ** -0.5, s[0] ** -0.5, s).astype(np.float32)  # noqa: E731
    p = {"ln1_g": 1 + 0.1 * rng.randn(C).astype(np.float32), "ln1_b": 0.1 * rng.randn(C).astype(np.float32),
         "q_w": u(2 * C, C), "q_b": u(C), "k_w": u(2 * C, C), "k_b": u(C), "v_w": u(C, C), "v_b": u(C),
         "ln2_g": 1 + 0.1 * rng.randn(C).astype(np.float32), "ln2_b": 0.1 * rng.randn(C).astype(np.float32),
         "mlp1_w": u(C, 4 * C), "mlp1_b": u(4 * C), "mlp2_w": u(4 * C, C), "mlp2_b": u(C)}
    x = rng.randn(1, 4, T, C).astype(np.float32)
    qg, kg = (rng.randn(1, T, C).astype(np.float32) * 0.3 for _ in range(2))
    tpar = {k: torch.from_numpy(v) for k, v in p.items()}
    jpar = {k: jnp.asarray(v) for k, v in p.items()}
    pkv, pks = tcl.pad_contributions(torch.from_numpy(rng.randn(C).astype(np.float32)),
                                     torch.from_numpy(rng.randn(C).astype(np.float32)), tpar, Tp - T, Tp, heads)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16).float()  # noqa: E731
    want = np.asarray(jcl._reference(jb(x), jb(qg) if guided else None, jb(kg) if guided else None,
                                     jnp.asarray(pkv.numpy()), jnp.asarray(pks.numpy()), jpar, heads, Tp),
                      np.float32)
    kp = tcl.kernel_params(tpar)
    for n in range(4):
        got = kernel_order(tb(x[0, n]), tb(qg[0]) if guided else None, tb(kg[0]) if guided else None,
                           pkv, pks, kp, heads, Tp)
        err = np.abs(got.numpy() - want[0, n]).max()
        assert err <= BOUND * max(1.0, np.abs(want[0, n]).max()), (n, err)
