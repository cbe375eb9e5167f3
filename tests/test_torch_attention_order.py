"""The rounding order of the tensor-core attention kernels, on the CPU.

csrc/clip_attn.cu (bf16) runs the FlashAttention-2 order: 64-key tiles, a
running max, P = exp(s - m_running) rounded to bf16 before the value
product (unnormalised), and one 1/l at the end, where catseg_tpu's
reference rounds the normalised P.  csrc/window_attn.cu keeps a window's
whole logit row in registers and normalises P before rounding it, as the
reference kernel does; rows longer than 144 keys (window 16) run as two
128-key halves in the dense kernel's order.  The kernels run only on the
card; here a plain-PyTorch emulation of each order, kept in this file, is
held to catseg_tpu at full width, so the order itself is shown to stay
inside the kernels' stated bounds (chip_smoke [3]): 2^-5 of max(1, |ref|)
in bf16, 1e-5 in fp32 (there nothing is rounded, only summed in another
order).

csrc/swin_block.cu's bf16 kernel keeps the reference's rounding points but
exponentiates on the SFU, exp(y) as 2^(y log2 e), and normalises P by one
reciprocal a row: that order, patched into the port's plain pair, is held
to catseg_tpu's bf16 ``_reference_pair`` within 2^-5.  Its weights reach
it in mma fragment order (``pack_mma_b``): the layout is checked element
by element and by emulating the kernel's fragment products.

Also on the CPU: the window-attention plain version with ``mask=None`` is
bit-equal to a zero mask (the unfused Swin block's unshifted half passes
None), and the wrapper takes the strided views of a fused qkv projection.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catseg_tpu.core import aggregator as jagg
from catseg_tpu.kernels import clip_attn as jca
from catseg_tpu.kernels import swin_block as jsw
from catseg_tpu.kernels import window_attn as jwa

from catseg_tpu_torch.kernels import _build
from catseg_tpu_torch.kernels import swin_block as tsw
from catseg_tpu_torch.kernels import window_attn as twa

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
BOUND = {"float32": 1e-5, "bfloat16": 2.0 ** -5}


def _inputs(shape, dt, seed):
    """numpy inputs rounded to dt, as (jax arrays, fp32 torch tensors)."""
    rng = np.random.RandomState(seed)
    jdt, tdt = DTYPES[dt]
    arrs = [rng.randn(*shape).astype(np.float32) for _ in range(3)]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt).float() for a in arrs])


def _rounder(dt):
    tdt = DTYPES[dt][1]
    return lambda t: t.to(tdt).float()


def _heads(t, heads):
    B, S, W = t.shape
    return t.reshape(B, S, heads, W // heads).transpose(1, 2)


def dense_kernel_order(q, k, v, heads: int, rnd, tile: int = 64):
    """csrc/clip_attn.cu's order on (B, S, W) fp32 tensors: 64-key tiles,
    running max m and sum l, O += rnd(exp(s - m)) V, the output O / l
    rounded by rnd."""
    B, S, W = q.shape
    D = W // heads
    qh, kh, vh = (_heads(t, heads) for t in (q, k, v))
    m = torch.full((B, heads, S, 1), -math.inf)
    l = torch.zeros((B, heads, S, 1))
    o = torch.zeros((B, heads, S, D))
    for k0 in range(0, S, tile):
        s = torch.matmul(qh, kh[:, :, k0:k0 + tile].transpose(-1, -2)) * D ** -0.5
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        c = torch.exp(m - mn)
        p = torch.exp(s - mn)
        l = l * c + p.sum(-1, keepdim=True)
        o = o * c + torch.matmul(rnd(p), vh[:, :, k0:k0 + tile])
        m = mn
    return rnd(o * (1.0 / l)).transpose(1, 2).reshape(B, S, W)


def window_kernel_order(q, k, v, mask, heads: int, scale: float, rnd, max_keys: int = 144):
    """csrc/window_attn.cu's tensor-core order on (Bw, N, C) fp32 tensors:
    logits = S * scale + mask; a row of at most 144 keys gets the exact
    softmax, P = rnd(exp(logit - m) / l), O = P V; a longer row runs in
    key chunks (16-key multiples, at most 144) with a running max and sum,
    O rescaled as the max moves, O += rnd(exp(logit - m)) V, then O / l.
    The output is rounded by rnd."""
    Bw, N, C = q.shape
    qh, kh, vh = (_heads(t, heads) for t in (q, k, v))
    pairs = N // 16
    nchunk = -(-pairs // (max_keys // 16))
    per = -(-pairs // nchunk)
    full = None if mask is None else mask.repeat(Bw // mask.shape[0], 1, 1)[:, None]
    m = torch.full((Bw, heads, N, 1), -math.inf)
    l = torch.zeros((Bw, heads, N, 1))
    o = torch.zeros_like(qh)
    for a, b in [(16 * per * c, min(N, 16 * per * (c + 1))) for c in range(nchunk)]:
        s = torch.matmul(qh, kh[:, :, a:b].transpose(-1, -2)) * scale
        if full is not None:
            s = s + full[..., a:b]
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        c = torch.exp(m - mn)
        e = torch.exp(s - mn)
        l = l * c + e.sum(-1, keepdim=True)
        m = mn
        if nchunk == 1:
            o = torch.matmul(rnd(e * (1.0 / l)), vh[:, :, a:b])
        else:
            o = o * c + torch.matmul(rnd(e), vh[:, :, a:b])
    if nchunk > 1:
        o = o * (1.0 / l)
    return rnd(o).transpose(1, 2).reshape(Bw, N, C)


def _check(got, want, dt):
    w = np.asarray(jnp.asarray(want, jnp.float32))
    g = got.numpy()
    assert g.shape == w.shape
    err = float(np.abs(g - w).max())
    assert err <= BOUND[dt] * max(1.0, float(np.abs(w).max())), err
    return err


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_dense_order_matches_reference_at_a_clip_layer(dt):
    """One image of a ViT-B/16 layer at 384^2: S = 577 (a ragged 1-key last
    tile), 12 heads, W = 768."""
    (jq, jk, jv), (tq, tk, tv) = _inputs((1, 577, 768), dt, seed=0)
    want = jca._reference(jq, jk, jv, 12)
    _check(dense_kernel_order(tq, tk, tv, 12, _rounder(dt)), want, dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("win", [12, 16], ids=["N144", "N256-two-chunks"])
def test_window_order_matches_reference_kernel(dt, win):
    """8 windows of win^2 tokens x 128 with the shift mask (4 heads, D = 32)
    against the Pallas kernel in interpret mode, as catseg_tpu's tests run it."""
    N = win * win
    (jq, jk, jv), (tq, tk, tv) = _inputs((8, N, 128), dt, seed=win)
    mask = np.array(jagg._shift_mask(2 * win, 2 * win, win, win // 2))
    want = jwa.fused_window_attention(jq, jk, jv, jnp.asarray(mask), 4, 32 ** -0.5)
    got = window_kernel_order(tq, tk, tv, torch.from_numpy(mask), 4, 32 ** -0.5, _rounder(dt))
    _check(got, want, dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_window_plain_no_mask_is_a_zero_mask(dt):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(8, 144, 128, generator=g).to(dt) for _ in range(3))
    none = twa.window_attention_plain(q, k, v, None, 4, 32 ** -0.5)
    zeros = twa.window_attention_plain(q, k, v, torch.zeros(4, 144, 144), 4, 32 ** -0.5)
    assert torch.equal(none, zeros)
    assert torch.equal(twa.fused_window_attention(q, k, v, None, 4, 32 ** -0.5), none)


def test_window_attention_takes_qkv_views():
    """The views of one fused projection, rows 3C apart, as the unfused Swin
    block passes them: equal to the call on contiguous copies, and the
    launcher's stride rule accepts them (and nothing more irregular)."""
    g = torch.Generator().manual_seed(4)
    qkv = torch.randn(2, 4, 144, 3 * 128, generator=g).to(torch.bfloat16)
    q, k, v = (t.reshape(-1, 144, 128) for t in qkv.split(128, dim=-1))
    assert not v.is_contiguous() and _build.rows_evenly_strided(v) and v.stride(1) == 384
    assert not _build.rows_evenly_strided(v.transpose(0, 1))
    assert not _build.rows_evenly_strided(qkv[:, :2, :, :128].reshape(-1, 144, 128)[::2])
    mask = torch.from_numpy(np.array(jagg._shift_mask(24, 24, 12, 6)))
    got = twa.fused_window_attention(q, k, v, mask, 4, 32 ** -0.5)
    want = twa.fused_window_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask, 4, 32 ** -0.5)
    assert torch.equal(got, want)


def _swin_params(rng, C=128):
    def u(*shape, scale=None):
        scale = scale or shape[0] ** -0.5
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    return {"ln1_g": 1 + u(C, scale=0.1), "ln1_b": u(C, scale=0.1), "qkv_w": u(C, 3 * C),
            "qkv_b": u(3 * C, scale=0.1), "proj_w": u(C, C), "proj_b": u(C, scale=0.1),
            "ln2_g": 1 + u(C, scale=0.1), "ln2_b": u(C, scale=0.1), "fc1_w": u(C, 4 * C),
            "fc1_b": u(4 * C, scale=0.1), "fc2_w": u(4 * C, C), "fc2_b": u(C, scale=0.1)}


def swin_kernel_softmax(logits, fast: bool):
    """csrc/swin_block.cu's bf16 softmax: e = 2^(min(logit, 60) log2 e), no
    max pass, P = e * (1 / sum) (rounded to bf16 by the caller)."""
    assert fast
    e = torch.exp2(logits.clamp_max(60.0) * (1.0 / math.log(2.0)))
    return e * (1.0 / e.sum(-1, keepdim=True))


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
def test_swin_order_matches_reference_pair(monkeypatch, guided):
    """Both blocks of a pair (shift 0, then 6 with the region mask) on a
    24 x 24 grid, T = 2, bf16, against catseg_tpu's _reference_pair."""
    rng = np.random.RandomState(11)
    x = rng.randn(1, 2, 24, 24, 128).astype(np.float32)
    guid4 = tuple(rng.randn(1, 24, 24, 128).astype(np.float32) * 0.5 for _ in range(4))
    p1, p2 = _swin_params(rng), _swin_params(rng)
    mask = jnp.asarray(np.array(jagg._shift_mask(24, 24, 12, 6)))
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    jp = lambda p: {k: jnp.asarray(v) for k, v in p.items()}  # noqa: E731
    tp = lambda p: {k: torch.from_numpy(v) for k, v in p.items()}  # noqa: E731
    want = jsw._reference_pair(jb(x), tuple(map(jb, guid4)) if guided else None, jp(p1), jp(p2), mask, 4, 12)
    monkeypatch.setattr(tsw, "_softmax_rows", swin_kernel_softmax)
    got = tsw.swin_pair_plain(tb(x), tuple(map(tb, guid4)) if guided else None, tp(p1), tp(p2), 4, 12)
    _check(got.float(), want, "bfloat16")


@pytest.mark.parametrize("K,N,depth", [(64, 24, 32), (128, 384, 32), (512, 128, 32), (128, 384, 16),
                                         (432, 32, 16), (288, 8, 16)],
                         ids=["toy", "class-qkv", "class-fc2", "decoder-convt1", "decoder-conv3", "decoder-head"])
def test_swin_weight_packing_is_the_mma_fragment_layout(K, N, depth):
    """pack_mma_b against the m16n8k16 fragment layout of csrc/attn_common.cuh,
    at the kernels' shapes (a toy one; #6's qkv and fc2 weights, 32 rows deep
    a block; #8's ConvT, 3x3-conv and padded head taps, 16 deep, where 9 x 48
    rows are no multiple of 32): element by element, and by emulating the kernels' gemm
    (A fragments as ldmatrix gives them, B from the packed bytes of each
    lane, C rows g and g + 8) on one 16-row strip of a (16, K) x (K, N)
    product."""
    rng = np.random.RandomState(5)
    w = rng.randn(K, N).astype(np.float32)
    packed = tsw.pack_mma_b(torch.from_numpy(w), depth).reshape(-1, depth // 4).numpy()
    kp = K // depth
    j, p, lane, r, h = np.meshgrid(np.arange(N // 8), np.arange(kp), np.arange(32), np.arange(depth // 8),
                                   np.arange(2), indexing="ij")
    g, t = lane // 4, lane % 4
    np.testing.assert_array_equal(packed[(j * kp + p) * 32 + lane, 2 * r + h],
                                  w[depth * p + 8 * r + 2 * t + h, 8 * j + g])
    # one 16-row strip through the kernel's loop: per k-step, the tiles the
    # mma sees are assembled from each lane's fragments as the layout places them
    a = rng.randn(16, K).astype(np.float32)
    c = np.zeros((16, N), np.float32)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    for jj in range(N // 8):
        for pp in range(kp):
            for q in range(depth // 16):
                ks = pp * (depth // 16) + q
                a_tile, b_tile = np.zeros((16, 16), np.float32), np.zeros((16, 8), np.float32)
                for dr, dk in ((0, 0), (8, 0), (0, 8), (8, 8)):   # a0..a3
                    for e in range(2):
                        a_tile[g + dr, 2 * t + dk + e] = a[g + dr, 16 * ks + 2 * t + dk + e]
                frag = packed[(jj * kp + pp) * 32 + np.arange(32), 4 * q:4 * q + 4]
                for e in range(2):
                    b_tile[2 * t + e, g] = frag[:, e]           # b0
                    b_tile[2 * t + 8 + e, g] = frag[:, 2 + e]   # b1
                c[:, 8 * jj:8 * jj + 8] += a_tile @ b_tile
    np.testing.assert_allclose(c, a @ w, rtol=1e-5, atol=1e-4)
