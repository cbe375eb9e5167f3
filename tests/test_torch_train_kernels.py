"""Gradients of the port's six kernel Functions against catseg_tpu's, on the CPU.

For each kernel module of the train step the same numpy inputs go through
the port's public wrapper (its ``torch.autograd.Function``: plain forward,
plain backward for CPU tensors) and through ``jax.vjp`` of the JAX entry
point, which runs as catseg_tpu's own tests run it here (the Pallas
backward kernels in interpret mode, or the reference's plain backward).
Every cotangent is compared: the input, the guidance or pad inputs and each
parameter, with the layout glue between the two (the qkv repack, the torch
(out, in) layouts, the decoder's guidance half) inside the comparison.
fp32.  Tolerance: max |port - jax| <= 1e-4 * max(1, max |jax|) per
gradient (summation order; the reference's fp32 GELU is a 1.5e-5-accurate
polynomial, the port uses erf).  The CUDA backward kernels themselves run
only on the card (test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catseg_tpu.core.aggregator import _shift_mask
from catseg_tpu.kernels import class_layer as jcl
from catseg_tpu.kernels import clip_attn as jca
from catseg_tpu.kernels import corr_embed as jce
from catseg_tpu.kernels import decoder as jdec
from catseg_tpu.kernels import layer_norm as jln
from catseg_tpu.kernels import swin_block as jsw

from catseg_tpu_torch.kernels import class_layer as tcl
from catseg_tpu_torch.kernels import clip_attn as tca
from catseg_tpu_torch.kernels import corr_embed as tce
from catseg_tpu_torch.kernels import decoder as tdec
from catseg_tpu_torch.kernels import layer_norm as tln
from catseg_tpu_torch.kernels import swin_block as tsw

from test_torch_decoder import _inputs as _dec_inputs
from test_torch_decoder import _jax_params as _dec_params
from test_torch_decoder import _port as _dec_port
from test_torch_kernels import _class_inputs, _corr_inputs, _swin_inputs

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's torch work runs on one thread: many small ops would each
    wait on a barrier of the whole thread pool, which stalls whenever the
    suite's parallel workers oversubscribe the cores (the JAX side
    dominates the time on a quiet machine either way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).requires_grad_()


def _check(name, got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.zeros_like(np.asarray(want))
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= TOL * max(1.0, float(np.abs(want).max())), (name, err)


def _cotangent(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _grads(out, inputs, g):
    out.backward(torch.from_numpy(g))
    return [t.grad for t in inputs]


def test_layer_norm_grads_match_jax():
    rng = np.random.RandomState(0)
    x, g, b = rng.randn(640, 128) * 2 + 0.5, rng.randn(128), rng.randn(128)
    dy = _cotangent(1, (640, 128))
    _, vjp = jax.vjp(jln.fused_layer_norm, *(jnp.asarray(a, jnp.float32) for a in (x, g, b)))
    want = vjp(jnp.asarray(dy))
    ts = [_t(a) for a in (x, g, b)]
    got = _grads(tln.fused_layer_norm(*ts), ts, dy)
    for n, a, w in zip(("dx", "dg", "db"), got, want):
        _check(n, a, w)


def test_dense_attention_grads_match_jax():
    rng = np.random.RandomState(1)
    qkv = [rng.randn(2, 65, 128).astype(np.float32) for _ in range(3)]
    dy = _cotangent(2, (2, 65, 128))
    _, vjp = jax.vjp(lambda q, k, v: jca.fused_dense_attention(q, k, v, 2), *map(jnp.asarray, qkv))
    ts = [_t(a) for a in qkv]
    got = _grads(tca.fused_dense_attention(*ts, 2), ts, dy)
    for n, a, w in zip("qkv", got, vjp(jnp.asarray(dy))):
        _check("d" + n, a, w)


def test_corr_embed_grads_match_jax():
    ins = _corr_inputs()
    dy = _cotangent(3, (1, 6, 24, 24, 128))
    _, vjp = jax.vjp(jce.fused_corr_embed, *map(jnp.asarray, ins))
    ts = [_t(a) for a in ins]
    got = _grads(tce.fused_corr_embed(*ts), ts, dy)
    for n, a, w in zip(("dimg", "dtext", "dw", "db"), got, vjp(jnp.asarray(dy))):
        _check(n, a, w)


def test_swin_pair_grads_match_jax():
    x, guid4, p1, p2 = _swin_inputs(4)
    dy = _cotangent(5, x.shape)
    mask = _shift_mask(24, 24, 12, 6)
    jp = lambda p: {k: jnp.asarray(v) for k, v in p.items()}  # noqa: E731
    _, vjp = jax.vjp(lambda x, g, a, b: jsw.fused_swin_pair(x, g, a, b, mask, 4, 12),
                     jnp.asarray(x), tuple(map(jnp.asarray, guid4)), jp(p1), jp(p2))
    jdx, jdg, jdp1, jdp2 = vjp(jnp.asarray(dy))
    tx, tg = _t(x), [_t(g) for g in guid4]
    tp1, tp2 = ({k: _t(v) for k, v in p.items()} for p in (p1, p2))
    tsw.fused_swin_pair(tx, tuple(tg), tp1, tp2, 4, 12).backward(torch.from_numpy(dy))
    _check("dx", tx.grad, jdx)
    for i, (a, w) in enumerate(zip(tg, jdg)):
        _check(f"dguid{i}", a.grad, w)
    for blk, (tp, jd) in enumerate(((tp1, jdp1), (tp2, jdp2))):
        for k in tp:
            _check(f"block{blk + 1}.{k}", tp[k].grad, jd[k])


def test_class_layer_grads_match_jax():
    """Through pad_contributions: the pad cotangents reach the padding rows,
    ln1 and the k / v projections (and the k guidance rows) on both sides."""
    x, qg, kg, p, tok, guid = _class_inputs(6)
    dy = _cotangent(7, x.shape)

    def jfn(x, qg, kg, tok, guid, p):
        pkv, pks = jcl.pad_contributions(tok, guid, p, 2, 8, 4)
        return jcl.fused_class_layer(x, qg, kg, pkv, pks, p, 4, 8)

    jins = [jnp.asarray(a) for a in (x, qg, kg, tok, guid)]
    _, vjp = jax.vjp(jfn, *jins, {k: jnp.asarray(v) for k, v in p.items()})
    *jd, jdp = vjp(jnp.asarray(dy))
    ts = [_t(a) for a in (x, qg, kg, tok, guid)]
    tp = {k: _t(v) for k, v in p.items()}
    pkv, pks = tcl.pad_contributions(ts[3], ts[4], tp, 2, 8, 4)
    tcl.fused_class_layer(ts[0], ts[1], ts[2], pkv, pks, tp, 4, 8).backward(torch.from_numpy(dy))
    for n, a, w in zip(("dx", "dqg", "dkg", "dpadding_tokens", "dpadding_guidance"), ts, jd):
        _check(n, a.grad, w)
    for k in tp:
        _check("d" + k, tp[k].grad, jdp[k])


def test_decoder_grads_match_jax():
    """B = 1, T = 2 at the flagship geometry; conv1's guidance half stays
    outside the Function on both sides, so the guidance and conv1_w[:, Cup:]
    get their gradients by autograd through it."""
    d1, d2, head = _dec_params()
    x, g1, g2 = _dec_inputs()
    dy = _cotangent(8, (2, 96, 96))
    tree = lambda d: jax.tree_util.tree_map(jnp.asarray, d)  # noqa: E731
    _, vjp = jax.vjp(lambda x, g1, g2, a, b, h: jdec.fused_decoder(x, g1, g2, a, b, h, 1, 2),
                     jnp.asarray(x), jnp.asarray(g1), jnp.asarray(g2), tree(d1), tree(d2), tree(head))
    jdx, jdg1, jdg2, jd1, jd2, jdh = vjp(jnp.asarray(dy))
    tx, tg1, tg2 = _t(x), _t(g1), _t(g2)
    td1, td2 = ({k: v.requires_grad_() for k, v in _dec_port(d).items()} for d in (d1, d2))
    thw = torch.from_numpy(np.ascontiguousarray(head["w"].transpose(3, 2, 0, 1))).requires_grad_()
    thb = _t(head["b"])
    tdec.fused_decoder(tx, tg1, tg2, td1, td2, {"w": thw, "b": thb}).backward(torch.from_numpy(dy))
    for n, a, w in (("dx", tx, jdx), ("dg1", tg1, jdg1), ("dg2", tg2, jdg2)):
        _check(n, a.grad, w)
    for s, (td, jd) in enumerate(((td1, jd1), (td2, jd2))):
        _check(f"d{s}.up_w", td["up_w"].grad, np.asarray(jd["up_w"]).transpose(0, 3, 1, 2))
        _check(f"d{s}.up_b", td["up_b"].grad, jd["up_b"])
        for c in ("conv1_w", "conv2_w"):
            _check(f"d{s}.{c}", td[c].grad, np.asarray(jd[c]).transpose(3, 2, 0, 1))
        for gn in ("gn1", "gn2"):
            _check(f"d{s}.{gn}_g", td[f"{gn}_g"].grad, jd[gn]["g"])
            _check(f"d{s}.{gn}_b", td[f"{gn}_b"].grad, jd[gn]["b"])
    _check("dhead_w", thw.grad, np.asarray(jdh["w"]).transpose(3, 2, 0, 1))
    _check("dhead_b", thb.grad, jdh["b"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_decoder_forward_on_cpu_is_decoder_plain(dtype):
    """The decoder Function's CPU forward (guidance planes, flat parameters)
    gives decoder_plain's logits bit for bit in both dtypes: the default
    configuration's CPU output is the plain decoder's, whatever the
    backward differentiates."""
    d1, d2, head = _dec_params()
    x, g1, g2 = (torch.from_numpy(a).to(dtype) for a in _dec_inputs())
    td1, td2 = (_dec_port(d) for d in (d1, d2))
    th = {"w": torch.from_numpy(np.ascontiguousarray(head["w"].transpose(3, 2, 0, 1))),
          "b": torch.from_numpy(head["b"])}
    want = tdec.decoder_plain(x, g1, g2, td1, td2, th)
    got = tdec.fused_decoder(x, g1, g2, td1, td2, th)
    assert got.dtype == want.dtype == torch.float32 and torch.equal(got, want)
