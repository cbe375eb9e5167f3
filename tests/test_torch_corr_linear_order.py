"""The order of arithmetic of the corr-embed and linear-attention kernels, on the CPU.

csrc/corr_embed.cu's bf16 path normalises each image once (fp32 statistics,
the result rounded to bf16), forms the cost map on mma.sync with fp32
accumulators, 16 products of E a k-step (each lane's 16-byte run of E split
over two k-steps, the same permutation on both operands), rounds it to bf16,
and runs the 7x7 conv as an implicit GEMM over 64 taps (dy * 8 + dx, the
dy = 7 and dx = 7 taps zero) whose accumulators start at the fp32 bias,
rounding once.  csrc/linear_attn.cu runs both products of the spec on
mma.sync in both dtypes with every fp32 operand split into a bf16 pair
hi = bf16(x), lo = bf16(x - hi), as hi.hi + hi.lo + lo.hi; the K sum rides
a ones column of the first product and the normaliser an extra column of
the second.  The kernels run only on the card; here a plain-PyTorch mirror
of each order, kept in this file, is held to catseg_tpu: the corr embed in
bf16 to ``_reference`` and to the Pallas kernel in interpret mode (2^-6 max,
1e-3 mean: tests/test_torch_kernels.py's bounds for the same comparison),
the linear attention to ``fused_linear_attention`` (the Pallas kernel at
S = 16, its reference at S = 13; head dims 32 and 128) within fp32 1e-4 and bf16 2^-5 of
max(1, |ref|), the bounds chip_smoke [3] holds the kernels to.  The same
mirror with the lo halves dropped fails the fp32 bound: the test sees the
split.  Also here: the bf16 taps as the wrapper packs them, read back
through the kernel's fragment indexing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catseg_tpu.kernels import corr_embed as jce
from catseg_tpu.kernels import linear_attn as jla

from catseg_tpu_torch.kernels import corr_embed as tce

from test_torch_kernels import _corr_inputs

bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731


def _mma_sum(a, b, steps):
    """sum_k a[..., k] b[k, ...] as mma.sync accumulates it: each k-step's
    products (exact for bf16 operands) summed, then added to the fp32
    accumulator in step order.  ``steps`` lists each k-step's k indices."""
    acc = None
    for ks in steps:
        part = torch.tensordot(a[..., ks].double(), b[ks].double(), dims=1).float()
        acc = part if acc is None else acc + part
    return acc


def _cost_steps(E):
    """The cost product's k-steps: per 32-wide block a lane t holds E
    elements 8t .. 8t + 7; k-step 0 takes 8t .. 8t + 3, k-step 1 the rest.
    In a last block past E (E % 32 in 8, 16, 24) a lane whose run lies past
    E holds zeros: its products drop out of the step."""
    out = []
    for e0 in range(0, E, 32):
        for half in (0, 4):
            out.append([e0 + 8 * t + half + i for t in range(4) for i in range(4) if e0 + 8 * t < E])
    return out


def corr_kernel_order(img, txt, w, b):
    """img (24, 24, E), txt (T, E) bf16-valued fp32, w (7, 7, 1, C), b (C,) ->
    (T, 24, 24, C) bf16-valued, in csrc/corr_embed.cu's bf16 order."""
    E = img.shape[-1]
    x = img.reshape(576, E)
    imgn = bf(x / x.square().sum(-1, keepdim=True).sqrt().clamp_min(1e-12))
    corr = bf(_mma_sum(imgn, txt.t(), _cost_steps(E)))                 # (576, T)
    T, C = txt.shape[0], w.shape[-1]
    planes = torch.zeros(T, 31, 32)                                     # row 30, columns 27.. zero
    planes[:, 3:27, 3:27] = corr.t().reshape(T, 24, 24)
    taps = torch.zeros(8, 8, C)
    taps[:7, :7] = bf(w[:, :, 0, :])
    # A[t, p, dy * 8 + dx] = plane[y + dy, x + dx]
    ys, xs = torch.meshgrid(torch.arange(24), torch.arange(24), indexing="ij")
    dy, dx = torch.meshgrid(torch.arange(8), torch.arange(8), indexing="ij")
    A = planes[:, (ys.reshape(-1, 1) + dy.reshape(1, -1)), (xs.reshape(-1, 1) + dx.reshape(1, -1))]
    steps = [list(range(16 * p, 16 * p + 16)) for p in range(4)]
    out = b.float() + _mma_sum(A, taps.reshape(64, C), steps)          # from the fp32 bias, 4 k-steps
    return bf(out).reshape(T, 24, 24, C)


@pytest.mark.parametrize("against", ["reference", "pallas"])
@pytest.mark.parametrize("T,E,C", [(6, 64, 128), (20, 64, 128), (6, 40, 256), (5, 48, 128)],
                         ids=["6", "20", "6-E40-C256", "5-E48"])
def test_corr_kernel_order_matches_jax(T, E, C, against):
    """At E a multiple of 32 or not (the last k step's lanes past E) and C =
    128 or two 128-channel blocks."""
    img, txt, w, b = _corr_inputs(seed=4 + T, T=T, E=E, C=C)
    ji, jt = jnp.asarray(img, jnp.bfloat16), jnp.asarray(txt, jnp.bfloat16)
    fn = jce._reference if against == "reference" else jce.fused_corr_embed   # Pallas in interpret mode here
    want = np.asarray(fn(ji, jt, jnp.asarray(w), jnp.asarray(b)), np.float32)
    got = corr_kernel_order(bf(torch.from_numpy(img[0])), bf(torch.from_numpy(txt[0, :, 0])),
                            torch.from_numpy(w), torch.from_numpy(b)).numpy()
    d = np.abs(got - want[0])
    # |out| < 2: a cost-map rounding tip moves one tap by 2^-8, an output tip 2^-7
    assert d.max() <= 2 ** -6 and d.mean() <= 1e-3, (d.max(), d.mean())


def test_corr_taps_pack_in_fragment_order():
    """csrc/corr_embed.cu reads the packed taps as uint2 (j * 4 + p) * 32 +
    lane: b0 = taps (16 p + 2t, +1) and b1 = (16 p + 8 + 2t, +1) of channel
    8 j + g, tap k = dy * 8 + dx."""
    w = torch.from_numpy(_corr_inputs(C=256)[2])
    packed = tce.pack_taps(w).reshape(-1, 4)      # rows: (j, p, lane), columns b0 lo, b0 hi, b1 lo, b1 hi
    for j in (0, 5, 15, 16, 31):   # 128-channel block cb: tiles 16 cb .. 16 cb + 15
        for p in range(4):
            for lane in (0, 7, 30):
                g, t = lane // 4, lane % 4
                got = packed[(j * 4 + p) * 32 + lane].float()
                for i, k in enumerate((16 * p + 2 * t, 16 * p + 2 * t + 1, 16 * p + 8 + 2 * t, 16 * p + 9 + 2 * t)):
                    dy, dx = divmod(k, 8)
                    want = bf(w[dy, dx, 0, 8 * j + g]) if dy < 7 and dx < 7 else torch.tensor(0.0)
                    assert got[i] == want, (j, p, lane, k)


def _split(x, keep_lo=True):
    hi = bf(x)
    return hi, (bf(x - hi) if keep_lo else torch.zeros_like(x))


def linear_kernel_order(q, k, v, heads, keep_lo=True):
    """q/k/v (N, S, C) fp32 holding the inputs' values -> (N, S, C) fp32, in
    csrc/linear_attn.cu's order: KV and the K sum over 16-row k-steps, the
    output and the normaliser over 16-channel k-steps of the head."""
    N, S, C = q.shape
    D = C // heads
    phi = lambda x: torch.where(x > 0, x + 1.0, torch.exp(x.clamp_max(0.0)))  # noqa: E731
    Q, K, V = phi(q), phi(k), v * (1.0 / S)
    out = torch.empty(N, S, C)
    rows = [list(range(s, min(s + 16, S))) for s in range(0, S, 16)]
    cols = [list(range(d, min(d + 16, D))) for d in range(0, D, 16)]
    for n in range(N):
        for h in range(heads):
            sl = slice(h * D, (h + 1) * D)
            (kh, kl), (vh, vl) = _split(K[n, :, sl], keep_lo), _split(V[n, :, sl], keep_lo)
            ext = torch.cat([vh, torch.ones(S, 1)], 1), torch.cat([vl, torch.zeros(S, 1)], 1)
            kv = sum(_mma_sum(a.t(), bb, rows) for a, bb in ((kh, ext[0]), (kh, ext[1]), (kl, ext[0])))
            (qh, ql), (bh, bl) = _split(Q[n, :, sl], keep_lo), _split(kv, keep_lo)
            o = sum(_mma_sum(a, bb, cols) for a, bb in ((qh, bh), (qh, bl), (ql, bh)))
            out[n, :, sl] = o[:, :D] * (1.0 / (o[:, D:] + 1e-6)) * S
    return out


def _linear_inputs(S, dt):
    rng = np.random.RandomState(10 + S)
    qkv = [rng.randn(4, S, 128).astype(np.float32) for _ in range(3)]
    jdt, tdt = (jnp.float32, torch.float32) if dt == "float32" else (jnp.bfloat16, torch.bfloat16)
    return [jnp.asarray(a, jdt) for a in qkv], [torch.from_numpy(a).to(tdt).float() for a in qkv], tdt


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,heads", [(16, 4), (13, 4), (16, 1)], ids=["pallas", "reference", "pallas-heads1"])
def test_linear_kernel_order_matches_jax(S, heads, dt):
    """Head dim 32, and 128 (one head: eight 16-channel k-steps in the
    output product)."""
    js, ts, tdt = _linear_inputs(S, dt)
    want = np.asarray(jla.fused_linear_attention(*js, heads), np.float32)
    got = linear_kernel_order(*ts, heads).to(tdt).float().numpy()
    bound = 1e-4 if dt == "float32" else 2 ** -5
    assert np.abs(got - want).max() <= bound * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("S", [16, 13], ids=["pallas", "reference"])
def test_linear_kernel_order_needs_the_lo_half(S):
    """Two-sided: without the lo halves (plain bf16 operands) the mirror
    misses the fp32 bound that it meets with them."""
    js, ts, _ = _linear_inputs(S, "float32")
    want = np.asarray(jla.fused_linear_attention(*js, 4), np.float32)
    scale = max(1.0, np.abs(want).max())
    with_lo = np.abs(linear_kernel_order(*ts, 4).numpy() - want).max()
    without = np.abs(linear_kernel_order(*ts, 4, keep_lo=False).numpy() - want).max()
    assert with_lo <= 1e-4 * scale < without, (with_lo, without)
