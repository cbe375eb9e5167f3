"""The bf16 backward kernels' order of arithmetic, on the CPU.

csrc/decoder_bwd.cu, csrc/swin_block_bwd.cu and csrc/class_layer_bwd.cu
run their bf16 paths on mma.sync tensor cores: each product's operands are
bf16 where the plain version's operand is a bf16 value (recomputed
activations, weights, and in the Swin block dout, P, q/k/v, dO, dx2, dqkv;
in the class layer dout, dh1, dy2, dy1, d(x + attention)), and a bf16 pair
hi + lo (hi = bf16(v), lo = bf16(v - hi)) where the plain version keeps it
fp32 (the decoder's cotangents, the Swin fc1 pre-activation gradient dh1,
the attention's dS, the class layer's dqkv); sums are fp32.  The kernels
run only on the card.  Here:

- the pair's rounding, and TF32's (cvt.rna.tf32.f32: to nearest, ties away,
  on the 13 dropped bits), held bit for bit against numpy bit-pattern
  versions over edge values (ties, subnormals, the largest finite value,
  inf, nan), and the pair's error against TF32's: the operand rule asks for
  at least TF32 where the plain version keeps fp32;
- that order emulated in torch (bf16 recompute with the kernels' roundings
  and single-pass statistics; each cotangent handed to a product at the
  kernel's precision by an identity whose backward rounds it), held per
  gradient, by relative Frobenius error, to ``jax.vjp`` of catseg_tpu's
  ``fused_swin_pair`` (as test_swin_pair_grads_match_jax runs it) in bf16
  at 2^-5, the bound selfcheck holds the card's kernels to against their
  plain versions; and for ``fused_decoder`` (B 1, T 2, as
  test_decoder_grads_match_jax runs it), whose bf16 gradients even
  catseg_tpu and the port's plain version decide only to ~10% here, at
  2^-5 from the port's plain version and at 2^-5 beyond the plain version's
  own distance from catseg_tpu's bf16 backward; and for
  ``fused_class_layer`` (B 1, T 6, 8 x 8, with and without guidance,
  through ``pad_contributions``, as test_class_layer_grads_match_jax runs
  it) in the same two-sided form as the decoder, because catseg_tpu's bf16
  class-layer backward rounds dh1 and dqkv to bf16 and normalises LN2 over
  the unrounded x + attention, where the port's plain version keeps dqkv
  fp32 and normalises the bf16 sum its forward stores.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catseg_tpu.core.aggregator import _shift_mask
from catseg_tpu.kernels import class_layer as jcl
from catseg_tpu.kernels import decoder as jdec
from catseg_tpu.kernels import swin_block as jsw

from catseg_tpu_torch.kernels import class_layer as tcl
from catseg_tpu_torch.kernels import decoder as tdec
from catseg_tpu_torch.kernels import swin_block as tsw
from catseg_tpu_torch.kernels.layer_norm import layer_norm_fp32
from catseg_tpu_torch.ops import conv2d, conv_transpose2d_nonoverlap
from catseg_tpu_torch.ops.window import window_partition, window_reverse

from test_torch_decoder import _inputs as _dec_inputs
from test_torch_decoder import _jax_params as _dec_params
from test_torch_decoder import _port as _dec_port
from test_torch_kernels import _class_inputs, _swin_inputs

BOUND = 2.0 ** -5


def bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def split(t: torch.Tensor) -> torch.Tensor:
    """The value a product reads from the pair hi = bf16(t), lo = bf16(t - hi)."""
    hi = bf(t)
    return hi + bf(t - hi)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as cvt.rna.tf32.f32 does it: add half of the 13 dropped
    bits' unit to the magnitude bits and clear them (ties away from zero, a
    carry into the exponent included); nan and inf pass."""
    u = x.contiguous().view(torch.int32)
    r = ((u + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x) | torch.isinf(x), x, r)


def _tf32_bits(v: np.float32) -> int:
    """numpy / Python bit-pattern TF32 rounding: sign, exponent, mantissa apart."""
    b = int(np.float32(v).view(np.uint32))
    sign, exp, man = b >> 31, (b >> 23) & 0xFF, b & 0x7FFFFF
    if exp == 0xFF:
        return b
    keep, rem = man >> 13, man & 0x1FFF
    if rem >= 0x1000:
        keep += 1
    if keep == 1 << 10:
        keep, exp = 0, exp + 1
    return (sign << 31) | (exp << 23) | (keep << 13)


def _bf16_bits(v: np.float32) -> int:
    """numpy / Python bit-pattern bf16 rounding to nearest, ties to even (fp32 bits)."""
    b = int(np.float32(v).view(np.uint32))
    keep, rem = b >> 16, b & 0xFFFF
    if rem > 0x8000 or (rem == 0x8000 and keep & 1):
        keep += 1
    return keep << 16


def _edge_values() -> np.ndarray:
    one = 1.0
    bits = [0x00000001, 0x00001000, 0x00003000, 0x007FFFFF, 0x007FF000, 0x00800000, 0x3F801000, 0x3F803000,
            0x3F800FFF, 0x3F808000, 0x3F818000, 0x3F80FFFF, 0x7F7FFFFF, 0x7F7FF000, 0x7F800000, 0x7FC00000,
            0x7F800001]
    v = np.concatenate([np.array(bits, np.uint32).view(np.float32),
                        np.float32([0.0, one, one + 2.0 ** -11, one + 3 * 2.0 ** -11, one + 2.0 ** -8,
                                    one + 3 * 2.0 ** -8, 1e-40, 3e-39, 65504.0, 1e30])])
    rng = np.random.RandomState(0)
    rand = (rng.randn(2000) * np.exp2(rng.randint(-60, 60, 2000))).astype(np.float32)
    return np.concatenate([v, -v, rand])


def test_tf32_rounding_is_cvt_rna_bit_for_bit():
    v = _edge_values()
    got = tf32_rna(torch.from_numpy(v)).numpy()
    want = np.array([_tf32_bits(a) for a in v], np.uint32).view(np.float32)
    nan = np.isnan(v)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    # the ties: 1 + 2^-11 is half a TF32 unit above 1 and rounds away, to 1 + 2^-10
    assert tf32_rna(torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


def test_hi_lo_pair_is_two_bf16_roundings_and_finer_than_tf32():
    v = _edge_values()
    v = v[np.isfinite(v) & (np.abs(v) < 3e38)]
    t = torch.from_numpy(v)
    hi = bf(t)
    lo = bf(t - hi)
    want_hi = np.array([_bf16_bits(a) for a in v], np.uint32).view(np.float32)
    want_lo = np.array([_bf16_bits(a - h) for a, h in zip(v, want_hi)], np.uint32).view(np.float32)
    assert np.array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    assert np.array_equal(lo.numpy().view(np.uint32), want_lo.view(np.uint32))
    normal = torch.from_numpy(np.abs(v) > 1e-30)
    rel = lambda r: ((t - r).abs() / t.abs())[normal].max().item()  # noqa: E731
    assert rel(split(t)) <= 2.0 ** -16 < 2.0 ** -11 / 8
    assert 2.0 ** -12 < rel(tf32_rna(t)) <= 2.0 ** -11


class _Cot(torch.autograd.Function):
    """Identity; its backward hands on fn(cotangent), the precision a kernel's
    products read that cotangent at."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def r(t: torch.Tensor) -> torch.Tensor:
    """A value rounded through bf16, its gradient passed straight through."""
    return t + (bf(t) - t).detach()


def _group_norm(h, g, b, groups):
    """The kernels' GroupNorm: fp32, single-pass variance, eps 1e-5."""
    N, H, W, C = h.shape
    v = h.reshape(N, H * W, groups, C // groups)
    mean = v.mean((1, 3), keepdim=True)
    var = (v * v).mean((1, 3), keepdim=True) - mean * mean
    return ((v - mean) * torch.rsqrt(var + 1e-5)).reshape(N, H, W, C) * g + b


def _decoder_trunk(x, hg1, hg2, p):
    """Both Up stages as csrc/decoder_bwd.cu's bf16 path recomputes and
    reverses them: every conv and ConvT output's cotangent read as hi + lo."""
    def stage(x, hg, s):
        u = r(r(conv_transpose2d_nonoverlap(x, r(p[f"up{s}_w"]), None, kernel=2)) + r(p[f"up{s}_b"]))
        u = _Cot.apply(u, split)
        h = conv2d(u, r(p[f"c{s}1_w"]), None, padding=1)
        h = r((h.reshape(hg.shape[0], -1, *h.shape[1:]) + hg.float()[:, None]).reshape(h.shape))
        h = _Cot.apply(h, split)
        mid = h.shape[-1]
        h = r(torch.relu(_group_norm(h, p[f"gn{s}1_g"], p[f"gn{s}1_b"], mid // 16)))
        h = _Cot.apply(r(conv2d(h, r(p[f"c{s}2_w"]), None, padding=1)), split)
        return r(torch.relu(_group_norm(h, p[f"gn{s}2_g"], p[f"gn{s}2_b"], mid // 16)))

    return stage(stage(x.float(), hg1, 1), hg2, 2)


class _DecoderKernelOrder(torch.autograd.Function):
    """The decoder Function with the plain forward and the bf16 kernel's backward order."""

    @staticmethod
    def forward(ctx, x, hg1, hg2, *params):
        ctx.save_for_backward(x, hg1, hg2, *params)
        return tdec._decoder_planes(x, hg1, hg2, *tdec._unpack(params))

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            p = {k: t.float() for k, t in zip(tdec._DK, ins[3:])}
            h4 = _decoder_trunk(*ins[:3], p)
            w = r(p["hd_w"])
            # the head: weight and bias grads from dout as hi + lo, the input grad a stencil of fp32 dout
            out_w = conv2d(h4.detach(), w, p["hd_b"], padding=1)[..., 0]
            g_hw, g_hb = torch.autograd.grad(out_w, (ins[-2], ins[-1]), split(dout))
            (dh4,) = torch.autograd.grad(conv2d(h4, w.detach(), None, padding=1)[..., 0], h4, dout)
            rest = torch.autograd.grad(h4, ins[:-2], dh4, allow_unused=True)
        grads = [bf(rest[0])] + list(rest[1:]) + [g_hw, g_hb]
        return tuple(g.to(t.dtype) for g, t in zip(grads, ctx.saved_tensors))


def _rel(got, want) -> float:
    got, want = got.detach().float(), torch.from_numpy(np.array(want, np.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _port_decoder_grads(d1, d2, head, x, g1, g2, dy, fn) -> dict:
    """Every gradient of the decoder (x, both guidance inputs, each parameter)
    through the port's fused_decoder in bf16, its Function's backward
    replaced by fn (None: the port's own, the plain version on the CPU)."""
    bf16 = torch.bfloat16
    tx, tg1, tg2 = (torch.from_numpy(a).to(bf16).requires_grad_() for a in (x, g1, g2))
    td1, td2 = ({k: v.requires_grad_() for k, v in _dec_port(d).items()} for d in (d1, d2))
    th = {"w": torch.from_numpy(np.ascontiguousarray(head["w"].transpose(3, 2, 0, 1))).requires_grad_(),
          "b": torch.from_numpy(head["b"]).requires_grad_()}
    if fn is None:
        out = tdec.fused_decoder(tx, tg1, tg2, td1, td2, th)
    else:
        hg1, hg2 = tdec._guidance_half(td1, tg1, 96, bf16), tdec._guidance_half(td2, tg2, 48, bf16)
        out = fn.apply(tx, hg1, hg2, *tdec._params(td1, td2, th))
    out.backward(torch.from_numpy(dy))
    g = {"dx": tx.grad, "dg1": tg1.grad, "dg2": tg2.grad, "dhead_w": th["w"].grad, "dhead_b": th["b"].grad}
    g.update({f"d{s}.{k}": v.grad for s, td in enumerate((td1, td2)) for k, v in td.items()})
    return g


def test_decoder_bwd_order_matches_jax_bf16():
    """The bf16 decoder backward's order against the port's plain backward
    and jax.vjp of catseg_tpu's fused_decoder in bf16 (its Pallas backward in
    interpret mode), B 1, T 2.  Here bf16 decides the gradients only to
    ~10%: catseg_tpu's own bf16 backward is 9.8e-2 from its fp32 one (dx),
    the port's plain version 8.3e-2 from catseg_tpu's bf16 (ReLUs after
    GroupNorm flip where bf16 rounding moves their inputs; the reference
    also rounds every cotangent to bf16).  So per gradient the order is held
    within 2^-5 of the plain version (the card's bound for the kernel) and
    within 2^-5 beyond the plain version's own distance from catseg_tpu."""
    d1, d2, head = _dec_params()
    x, g1, g2 = _dec_inputs()
    dy = np.random.RandomState(8).randn(2, 96, 96).astype(np.float32)
    tree = lambda d: jax.tree_util.tree_map(jnp.asarray, d)  # noqa: E731
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    _, vjp = jax.vjp(lambda x, g1, g2, a, b, h: jdec.fused_decoder(x, g1, g2, a, b, h, 1, 2),
                     jb(x), jb(g1), jb(g2), tree(d1), tree(d2), tree(head))
    jdx, jdg1, jdg2, jd1, jd2, jdh = vjp(jnp.asarray(dy))
    want = {"dx": jdx, "dg1": jdg1, "dg2": jdg2, "dhead_w": np.asarray(jdh["w"]).transpose(3, 2, 0, 1),
            "dhead_b": jdh["b"]}
    for s, jd in enumerate((jd1, jd2)):
        want[f"d{s}.up_w"] = np.asarray(jd["up_w"]).transpose(0, 3, 1, 2)
        want[f"d{s}.up_b"] = jd["up_b"]
        for c in ("conv1_w", "conv2_w"):
            want[f"d{s}.{c}"] = np.asarray(jd[c]).transpose(3, 2, 0, 1)
        for gn in ("gn1", "gn2"):
            want[f"d{s}.{gn}_g"], want[f"d{s}.{gn}_b"] = jd[gn]["g"], jd[gn]["b"]
    got = _port_decoder_grads(d1, d2, head, x, g1, g2, dy, _DecoderKernelOrder)
    plain = _port_decoder_grads(d1, d2, head, x, g1, g2, dy, None)
    bad = {k: (f"{_rel(got[k], plain[k].float().numpy()):.2e}", f"{_rel(got[k], w):.2e}",
               f"{_rel(plain[k], w):.2e}") for k, w in want.items()
           if not (_rel(got[k], plain[k].float().numpy()) <= BOUND and _rel(got[k], w) <= _rel(plain[k], w) + BOUND)}
    assert not bad, bad   # (order vs plain, order vs catseg_tpu, plain vs catseg_tpu)


def _swin_trunk(x, qg, kg, P, shift):
    """One Swin block as csrc/swin_block_bwd.cu's bf16 path recomputes and
    reverses it: dout, dx2, dO and dqkv in bf16, dS and dh1 as hi + lo."""
    B, T, H, W, C = x.shape
    heads, win = 4, 12
    D, nW = C // heads, (H // win) * (W // win)
    to16 = lambda t: _Cot.apply(t, bf)  # noqa: E731

    def part(a):
        return window_partition(a.reshape(B * T, H, W, C), win).reshape(B * T, nW, win * win, heads, D)

    xf = x.reshape(B * T, H * W, C)
    y = r(layer_norm_fp32(xf, P["ln1_g"], P["ln1_b"], True))
    qkv = r(y @ P["qkv_w"] + P["qkv_b"])
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, T, H, W, C) for i in range(3))
    if qg is not None:
        q, k = r(q + qg.float()[:, None]), r(k + kg.float()[:, None])
    q, k, v = to16(q), to16(k), to16(v)
    if shift > 0:
        q, k, v = (torch.roll(a, (-shift, -shift), dims=(2, 3)) for a in (q, k, v))
    qh, kh, vh = (part(a).permute(0, 1, 3, 2, 4) for a in (q, k, v))
    logits = _Cot.apply(torch.matmul(qh, kh.transpose(-1, -2)), split) * (D ** -0.5)
    if shift > 0:
        logits = logits + tsw.shift_mask(H, W, win, shift)[None, :, None]
    attn = tsw._softmax_rows(logits, True)
    out = to16(r(torch.matmul(r(attn), vh)))
    out = window_reverse(out.permute(0, 1, 3, 2, 4).reshape(B * T * nW, win * win, C), win, H, W)
    if shift > 0:
        out = torch.roll(out, (shift, shift), dims=(1, 2))
    out = out.reshape(B * T, H * W, C) @ P["proj_w"] + P["proj_b"]
    xf2 = to16(r(xf + r(out)))
    y2 = r(layer_norm_fp32(xf2, P["ln2_g"], P["ln2_b"], True))
    h1 = _Cot.apply(y2 @ P["fc1_w"] + P["fc1_b"], split)
    o = r(tsw.gelu(h1, True)) @ P["fc2_w"] + P["fc2_b"]
    return r(xf2 + r(o)).reshape(B, T, H, W, C)


class _SwinKernelOrder(torch.autograd.Function):
    """One Swin block with the plain forward and the bf16 kernel's backward order."""

    @staticmethod
    def forward(ctx, x, qg, kg, shift, *params):
        ctx.save_for_backward(x, qg, kg, *params)
        ctx.shift = shift
        return tsw.swin_block_plain(x, qg, kg, dict(zip(tsw._KEYS, params)), 4, 12, shift)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().float().requires_grad_() for t in saved]
            P = {k: t if k.startswith("ln") else r(t) for k, t in zip(tsw._KEYS, ins[3:])}
            out = _swin_trunk(ins[0], ins[1], ins[2], P, ctx.shift)
            grads = torch.autograd.grad(out, ins, dout.float())
        return (bf(grads[0]).to(saved[0].dtype), *(g.to(t.dtype) for g, t in zip(grads[1:3], saved[1:3])), None,
                *(g.to(t.dtype) for g, t in zip(grads[3:], saved[3:])))


def test_swin_bwd_order_matches_jax_bf16():
    """The bf16 Swin block backward's order, both blocks of a guided pair,
    against jax.vjp of catseg_tpu's fused_swin_pair in bf16."""
    bf16 = torch.bfloat16
    x, guid4, p1, p2 = _swin_inputs(4)
    dy = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    jp = lambda p: {k: jnp.asarray(v) for k, v in p.items()}  # noqa: E731
    mask = _shift_mask(24, 24, 12, 6)
    _, vjp = jax.vjp(lambda x, g, a, b: jsw.fused_swin_pair(x, g, a, b, mask, 4, 12),
                     jb(x), tuple(map(jb, guid4)), jp(p1), jp(p2))
    jdx, jdg, jdp1, jdp2 = vjp(jb(dy))
    tx = torch.from_numpy(x).to(bf16).requires_grad_()
    tg = [torch.from_numpy(g).to(bf16).requires_grad_() for g in guid4]
    tp1, tp2 = ({k: torch.from_numpy(v).requires_grad_() for k, v in p.items()} for p in (p1, p2))
    h = _SwinKernelOrder.apply(tx, tg[0], tg[1], 0, *(tp1[k] for k in tsw._KEYS))
    out = _SwinKernelOrder.apply(h, tg[2], tg[3], 6, *(tp2[k] for k in tsw._KEYS))
    out.backward(torch.from_numpy(dy).to(bf16))
    errs = {"dx": _rel(tx.grad, jdx)}
    errs.update({f"dguid{i}": _rel(a.grad, w) for i, (a, w) in enumerate(zip(tg, jdg))})
    for blk, (tp, jd) in enumerate(((tp1, jdp1), (tp2, jdp2))):
        errs.update({f"block{blk + 1}.{k}": _rel(tp[k].grad, jd[k]) for k in tp})
    assert max(errs.values()) <= BOUND, {k: f"{v:.2e}" for k, v in errs.items()}


def test_swin_emulation_forward_is_the_plain_block():
    """The emulation's hooks round cotangents only: the Swin trunk's forward
    is swin_block_plain's in bf16, bit for bit, so the comparison above
    judges the backward's order alone."""
    x, guid4, p, _ = _swin_inputs(0)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    qg, kg = (torch.from_numpy(g).to(torch.bfloat16) for g in guid4[:2])
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    P = {k: v if k.startswith("ln") else bf(v) for k, v in tp.items()}
    got = _swin_trunk(tx.float(), qg, kg, P, 6)
    assert torch.equal(got, tsw.swin_block_plain(tx, qg, kg, tp, 4, 12, 6).float())


def _class_trunk(x, qg, kg, pad_kv, pad_ksum, P, Tp):
    """One class layer as csrc/class_layer_bwd.cu's bf16 path recomputes and
    reverses it: _plain's forward, its roundings straight-through, and each
    cotangent at the precision the kernel hands it to its product: dy1, dy2,
    d(x + attention) and dh1 in bf16, dqkv (after the guidance add, so the
    guidance sums read it too) as hi + lo."""
    B, T, H, W, C = x.shape
    heads, D = 4, C // 4
    to16 = lambda t: _Cot.apply(t, bf)  # noqa: E731
    x32 = x.permute(0, 2, 3, 1, 4).reshape(B, H * W, T, C)
    y = to16(r(layer_norm_fp32(x32, P["ln1_g"], P["ln1_b"], True)))
    qkv = y @ P["qkv_w"] + P["qkv_b"]
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]
    if qg is not None:
        q = q + qg[:, None]
        k = k + kg[:, None]
    q, k, v = (_Cot.apply(a, split) for a in (q, k, v))
    Qh = tcl._elu1(q).reshape(B, H * W, T, heads, D)
    Kh = tcl._elu1(k).reshape(B, H * W, T, heads, D)
    Vh = (v / Tp).reshape(B, H * W, T, heads, D)
    hi = torch.arange(heads)
    kv = torch.einsum("bnthd,bnthe->bnhde", Kh, Vh) + pad_kv.reshape(heads, D, heads, D)[hi, :, hi, :]
    ksum = Kh.sum(2) + pad_ksum.reshape(heads, D)
    z = torch.einsum("bnthd,bnhd->bnth", Qh, ksum)
    attn = torch.einsum("bnthd,bnhde->bnthe", Qh, kv) * (Tp / (z[..., None] + tcl._EPS))
    seq = to16(r(x32 + attn.reshape(B, H * W, T, C)))
    y2 = to16(r(layer_norm_fp32(seq, P["ln2_g"], P["ln2_b"], True)))
    h = to16(r(torch.relu(y2 @ P["mlp1_w"] + P["mlp1_b"])))
    out = r(seq + r(h @ P["mlp2_w"] + P["mlp2_b"]))
    return out.reshape(B, H, W, T, C).permute(0, 3, 1, 2, 4)


class _ClassKernelOrder(torch.autograd.Function):
    """One class layer with the plain forward and the bf16 kernel's backward order."""

    @staticmethod
    def forward(ctx, x, qg, kg, pad_kv, pad_ksum, Tp, *params):
        ctx.save_for_backward(x, qg, kg, pad_kv, pad_ksum, *params)
        ctx.Tp = Tp
        return tcl._plain(x, qg, kg, pad_kv, pad_ksum, dict(zip(tcl._KP, params)), 4, Tp)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [None if t is None else t.detach().float().requires_grad_() for t in saved]
            P = {k: r(t) if k.endswith("_w") else t for k, t in zip(tcl._KP, ins[5:])}
            out = _class_trunk(*ins[:5], P, ctx.Tp)
            live = [t for t in ins if t is not None]
            got = iter(torch.autograd.grad(out, live, dout.float()))
            grads = [None if t is None else next(got) for t in ins]
        return (bf(grads[0]).to(saved[0].dtype), *(None if g is None else g.to(t.dtype)
                                                    for g, t in zip(grads[1:5], saved[1:5])), None,
                *(g.to(t.dtype) for g, t in zip(grads[5:], saved[5:])))


def _class_grads(x, qg, kg, tok, guid, p, dy, fn) -> dict:
    """Every gradient of one bf16 class layer (x, the guidance, the padding
    token and its guidance, each parameter) through pad_contributions and
    the port's layer, its Function's backward replaced by fn (None: the
    port's own, the plain version on the CPU)."""
    bf16 = torch.bfloat16
    tx = torch.from_numpy(x).to(bf16).requires_grad_()
    tq, tk = ((torch.from_numpy(a).to(bf16).requires_grad_() for a in (qg, kg)) if qg is not None
              else (None, None))
    ttok = torch.from_numpy(tok).requires_grad_()
    tguid = None if guid is None else torch.from_numpy(guid).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    pkv, pks = tcl.pad_contributions(ttok, tguid, tp, 2, 8, 4)
    if fn is None:
        out = tcl.fused_class_layer(tx, tq, tk, pkv, pks, tp, 4, 8)
    else:
        kp = tcl.kernel_params(tp)
        out = fn.apply(tx, tq, tk, pkv, pks, 8, *(kp[k] for k in tcl._KP))
    out.backward(torch.from_numpy(dy).to(bf16))
    g = {"dx": tx.grad, "dtok": ttok.grad, **{f"d{k}": v.grad for k, v in tp.items()}}
    if qg is not None:
        g.update(dqg=tq.grad, dkg=tk.grad, dguid=tguid.grad)
    return g


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
def test_class_bwd_order_matches_jax_bf16(guided):
    """The bf16 class-layer backward's order against the port's plain
    backward and jax.vjp of catseg_tpu's fused_class_layer in bf16 (its
    Pallas backward in interpret mode), through pad_contributions, B 1, T 6
    on 8 x 8 positions: per gradient within 2^-5 of the plain version and
    within 2^-5 beyond the plain version's own distance from catseg_tpu."""
    x, qg, kg, p, tok, guid = _class_inputs(6)
    if not guided:
        qg = kg = guid = None
    dy = np.random.RandomState(7).randn(*x.shape).astype(np.float32)
    jb = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)  # noqa: E731

    def jfn(x, qg, kg, tok, guid, p):
        pkv, pks = jcl.pad_contributions(tok, guid, p, 2, 8, 4)
        return jcl.fused_class_layer(x, qg, kg, pkv, pks, p, 4, 8)

    jins = (jb(x), jb(qg), jb(kg), jnp.asarray(tok), None if guid is None else jnp.asarray(guid))
    _, vjp = jax.vjp(jfn, *jins, {k: jnp.asarray(v) for k, v in p.items()})
    jdx, jdqg, jdkg, jdtok, jdguid, jdp = vjp(jb(dy))
    want = {"dx": jdx, "dtok": jdtok, **{f"d{k}": v for k, v in jdp.items()}}
    if guided:
        want.update(dqg=jdqg, dkg=jdkg, dguid=jdguid)
    got = _class_grads(x, qg, kg, tok, guid, p, dy, _ClassKernelOrder)
    plain = _class_grads(x, qg, kg, tok, guid, p, dy, None)
    assert set(got) == set(want) == set(plain)
    bad = {k: (f"{_rel(got[k], plain[k].float().numpy()):.2e}", f"{_rel(got[k], w):.2e}",
               f"{_rel(plain[k], w):.2e}") for k, w in want.items()
           if not (_rel(got[k], plain[k].float().numpy()) <= BOUND and _rel(got[k], w) <= _rel(plain[k], w) + BOUND)}
    assert not bad, bad   # (order vs plain, order vs catseg_tpu, plain vs catseg_tpu)


def test_class_emulation_forward_is_the_plain_layer():
    """The emulation's hooks round cotangents only: the class trunk's forward
    is class_layer_plain's in bf16, bit for bit, so the comparison above
    judges the backward's order alone."""
    x, qg, kg, p, tok, guid = _class_inputs(3)
    tx, tq, tk = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, qg, kg))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    pkv, pks = tcl.pad_contributions(torch.from_numpy(tok), torch.from_numpy(guid), tp, 2, 8, 4)
    kp = tcl.kernel_params(tp)
    P = {k: bf(kp[k]) if k.endswith("_w") else kp[k].float() for k in tcl._KP}
    got = _class_trunk(tx.float(), tq.float(), tk.float(), pkv, pks, P, 8)
    assert torch.equal(got, tcl.class_layer_plain(tx, tq, tk, pkv, pks, tp, 4, 8).float())
