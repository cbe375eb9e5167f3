"""The port's kernel modules against catseg_tpu's kernels, on the CPU.

Each catseg_tpu_torch kernel module's plain PyTorch version (what its
wrapper runs for CPU tensors) is fed the same numpy inputs as the JAX
kernel, which runs as catseg_tpu's own tests run it here (Pallas interpret
mode, or its plain reference off-TPU).  Shapes are small but inside every
JAX kernel gate (C = 128, 24x24 grid, window 12, >= 512 LN rows).

Tolerances: fp32 at 1e-4 abs or tighter (summation order; the reference's
fp32 GELU is a 1.5e-5-accurate polynomial, the port uses erf).  bf16 cases
compare with the reference spec in bf16: both sides round the same fp32
quantities to bf16, so they differ by a few bf16 ulps (2^-8 relative) where
fp32 summation order tips a rounding; the bounds below allow that and no
more, and they fail if a fast-form gate (tanh GELU, single-pass variance,
max-free softmax) is keyed differently.  Kernels themselves run only on the
card (test_torch_cuda.py, chip_smoke.py).
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
from catseg_tpu.kernels import layer_norm as jln
from catseg_tpu.kernels import swin_block as jsw

from catseg_tpu_torch.kernels import class_layer as tcl
from catseg_tpu_torch.kernels import clip_attn as tca
from catseg_tpu_torch.kernels import corr_embed as tce
from catseg_tpu_torch.kernels import layer_norm as tln
from catseg_tpu_torch.kernels import swin_block as tsw

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dt):
    """One numpy array -> (jax array, torch tensor) of the same values and dtype."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(a, b):
    d = np.abs(_np(a) - _np(b))
    return float(d.max()), float(d.mean())


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_layer_norm_matches_pallas(dt):
    rng = np.random.RandomState(0)
    x = rng.randn(640, 128).astype(np.float32) * 2 + 0.5
    g = rng.randn(128).astype(np.float32)
    b = rng.randn(128).astype(np.float32)
    jx, tx = _pair(x, dt)
    want = jln.fused_layer_norm(jx, jnp.asarray(g), jnp.asarray(b))
    got = tln.fused_layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == DTYPES[dt][1] and tln.kernel_applicable(tx)
    mx, _ = _err(got, want)
    # bf16: one ulp of |y| <= ~8 is 2^-5
    assert mx <= (1e-5 if dt == "float32" else 2 ** -5), mx


def test_layer_norm_gate_mirrors_reference():
    assert not tln.kernel_applicable(torch.zeros(511, 128))
    assert not tln.kernel_applicable(torch.zeros(600, 96))
    assert tln.kernel_applicable(torch.zeros(2, 300, 768))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_dense_attention_matches_reference(dt):
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(2, 65, 128).astype(np.float32) for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dt) for a in (q, k, v))
    want = jca.fused_dense_attention(jq, jk, jv, 2)
    got = tca.fused_dense_attention(tq, tk, tv, 2)
    mx, _ = _err(got, want)
    # bf16: outputs are averages of N(0,1) values, |o| < 4: 2 ulps = 2^-5
    assert mx <= (1e-5 if dt == "float32" else 2 ** -5), mx
    assert tca.dense_attention_applicable(768, 12, None)
    assert not tca.dense_attention_applicable(512, 8, np.zeros((1,)))


def _corr_inputs(seed=2, T=6, E=64):
    rng = np.random.RandomState(seed)
    img = rng.randn(1, 24, 24, E).astype(np.float32)
    txt = rng.randn(1, T, 1, E).astype(np.float32)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    w = rng.uniform(-0.15, 0.15, (7, 7, 1, 128)).astype(np.float32)
    b = rng.uniform(-0.15, 0.15, (128,)).astype(np.float32)
    return img, txt, w, b


def test_corr_embed_matches_pallas_fp32():
    img, txt, w, b = _corr_inputs()
    want = jce.fused_corr_embed(*(jnp.asarray(a) for a in (img, txt, w, b)))
    got = tce.fused_corr_embed(*(torch.from_numpy(a) for a in (img, txt, w, b)))
    assert got.shape == (1, 6, 24, 24, 128)
    assert _err(got, want)[0] <= 1e-5


def test_corr_embed_matches_reference_bf16():
    img, txt, w, b = _corr_inputs(seed=3)
    ji, ti = _pair(img, "bfloat16")
    jt, tt = _pair(txt, "bfloat16")
    want = jce._reference(ji, jt, jnp.asarray(w), jnp.asarray(b))
    got = tce.corr_embed_plain(ti, tt, torch.from_numpy(w), torch.from_numpy(b))
    mx, mean = _err(got, want)
    # |out| < 2 (49 taps of |w| < 0.15 on |cos| <= 1): a cost-map rounding tip
    # moves one tap by 2^-8, one output rounding tip by 2^-7
    assert mx <= 2 ** -6 and mean <= 1e-3, (mx, mean)
    assert tce.corr_embed_applicable(ti, tt, torch.from_numpy(w))


def _swin_params(rng, C=128):
    def u(*s, scale=None):
        scale = scale or s[0] ** -0.5
        return rng.uniform(-scale, scale, s).astype(np.float32)

    return {"ln1_g": 1 + u(C, scale=0.1), "ln1_b": u(C, scale=0.1), "qkv_w": u(C, 3 * C),
            "qkv_b": u(3 * C, scale=0.1), "proj_w": u(C, C), "proj_b": u(C, scale=0.1),
            "ln2_g": 1 + u(C, scale=0.1), "ln2_b": u(C, scale=0.1), "fc1_w": u(C, 4 * C),
            "fc1_b": u(4 * C, scale=0.1), "fc2_w": u(4 * C, C),
            "fc2_b": u(C, scale=0.1)}


def _swin_inputs(seed, T=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, T, 24, 24, 128).astype(np.float32)
    guid4 = tuple(rng.randn(1, 24, 24, 128).astype(np.float32) * 0.5 for _ in range(4))
    return x, guid4, _swin_params(rng), _swin_params(rng)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_swin_pair_matches_pallas(dt):
    x, guid4, p1, p2 = _swin_inputs(4)
    jx, tx = _pair(x, dt)
    jg, tg = zip(*(_pair(g, dt) for g in guid4))
    mask = _shift_mask(24, 24, 12, 6)
    jp = lambda p: {k: jnp.asarray(v) for k, v in p.items()}  # noqa: E731
    tp = lambda p: {k: torch.from_numpy(v) for k, v in p.items()}  # noqa: E731
    if dt == "float32":
        want = jsw.fused_swin_pair(jx, jg, jp(p1), jp(p2), mask, 4, 12)
    else:  # the spec, in the dtype whose fast forms it selects
        want = jsw._reference_pair(jx, jg, jp(p1), jp(p2), mask, 4, 12)
    got = tsw.fused_swin_pair(tx, tg, tp(p1), tp(p2), 4, 12)
    mx, mean = _err(got, want)
    if dt == "float32":
        assert mx <= 1e-4, mx
    else:
        # |x| < ~8 after two residual blocks: 2^-5 is two ulps there
        assert mx <= 2 ** -4 and mean <= 2e-3, (mx, mean)


def test_shift_mask_matches_reference():
    np.testing.assert_array_equal(tsw.shift_mask(24, 24, 12, 6).numpy(),
                                  np.asarray(_shift_mask(24, 24, 12, 6)))


def _class_inputs(seed, T=6, H=8, C=128, Cg=128):
    rng = np.random.RandomState(seed)
    u = lambda *s: rng.uniform(-s[0] ** -0.5, s[0] ** -0.5, s).astype(np.float32)  # noqa: E731
    p = {"ln1_g": 1 + 0.1 * rng.randn(C).astype(np.float32), "ln1_b": 0.1 * rng.randn(C).astype(np.float32),
         "q_w": u(C + Cg, C), "q_b": u(C), "k_w": u(C + Cg, C), "k_b": u(C), "v_w": u(C, C), "v_b": u(C),
         "ln2_g": 1 + 0.1 * rng.randn(C).astype(np.float32), "ln2_b": 0.1 * rng.randn(C).astype(np.float32),
         "mlp1_w": u(C, 4 * C), "mlp1_b": u(4 * C), "mlp2_w": u(4 * C, C), "mlp2_b": u(C)}
    x = rng.randn(1, T, H, H, C).astype(np.float32)
    qg = rng.randn(1, T, C).astype(np.float32) * 0.3
    kg = rng.randn(1, T, C).astype(np.float32) * 0.3
    pad_tok = rng.randn(C).astype(np.float32)
    pad_guid = rng.randn(Cg).astype(np.float32)
    return x, qg, kg, p, pad_tok, pad_guid


def test_pad_contributions_match_reference():
    _, _, _, p, tok, guid = _class_inputs(5)
    jkv, jks = jcl.pad_contributions(jnp.asarray(tok), jnp.asarray(guid),
                                     {k: jnp.asarray(v) for k, v in p.items()}, 2, 8, 4)
    tkv, tks = tcl.pad_contributions(torch.from_numpy(tok), torch.from_numpy(guid),
                                     {k: torch.from_numpy(v) for k, v in p.items()}, 2, 8, 4)
    assert _err(tkv, jkv)[0] <= 1e-5 and _err(tks, jks)[0] <= 1e-5


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_class_layer_matches_pallas(dt):
    x, qg, kg, p, tok, guid = _class_inputs(6)
    jpar = {k: jnp.asarray(v) for k, v in p.items()}
    tpar = {k: torch.from_numpy(v) for k, v in p.items()}
    pkv, pks = jcl.pad_contributions(jnp.asarray(tok), jnp.asarray(guid), jpar, 2, 8, 4)
    jx, tx = _pair(x, dt)
    (jqg, tqg), (jkg, tkg) = _pair(qg, dt), _pair(kg, dt)
    tpkv, tpks = torch.tensor(np.asarray(pkv)), torch.tensor(np.asarray(pks))
    got = tcl.fused_class_layer(tx, tqg, tkg, tpkv, tpks, tpar, 4, 8)
    if dt == "float32":
        want = jcl.fused_class_layer(jx, jqg, jkg, pkv, pks, jpar, 4, 8)
        assert _err(got, want)[0] <= 1e-4
    else:  # the spec (_reference, position-major) in bf16
        B, T, H, W, C = x.shape
        x_pm = jx.transpose(0, 2, 3, 1, 4).reshape(B, H * W, T, C)
        want = jcl._reference(x_pm, jqg, jkg, pkv, pks, jpar, 4, 8)
        want = want.reshape(B, H, W, T, C).transpose(0, 3, 1, 2, 4)
        mx, mean = _err(got, want)
        # |out| < ~8: two ulps 2^-5, rounding tips are rare
        assert mx <= 2 ** -4 and mean <= 2e-3, (mx, mean)


def test_launch_refuses_host_tensors():
    """A host tensor never reaches a CUDA kernel as a pointer: launch()
    raises before it loads (or builds) the library."""
    from catseg_tpu_torch.kernels import _build

    with pytest.raises(ValueError, match="one CUDA device"):
        _build.launch("catseg_dense_attention", torch.zeros(4), torch.zeros(4))
