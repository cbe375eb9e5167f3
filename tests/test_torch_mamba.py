"""The port's MambaIR selective scan and VSSBlock against catseg_tpu's, on
the CPU, fp32, at tests/test_mamba.py's dims: ``selective_scan`` (B 2, 4
groups of 6 channels, L 10, N 5, random inputs) and the VSSBlock (d_model
32, d_state 4, expand 2, 2 x 8 x 8 x 32 input; catseg_tpu's seeded
parameters carried over by ``weights.from_jax.vss_block_state_dict``), each
within 1e-5 of max(1, |ref|).  catseg_tpu's LayerNorm kernel takes its plain
path at these widths."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from catseg_tpu.core import mamba as jmamba

from catseg_tpu_torch.core import mamba
from catseg_tpu_torch.weights.from_jax import vss_block_state_dict


# jitted: catseg_tpu's eager init and forward compile op by op (~9 s each)
_init = jax.jit(jmamba.init_vss_block, static_argnums=1)
_forward = jax.jit(jmamba.vss_block_forward, static_argnums=2)


def _close(got, want):
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err


def test_selective_scan_matches_jax():
    rng = np.random.RandomState(0)
    B, G, Dg, L, N = 2, 4, 6, 10, 5
    Dp = G * Dg
    args = [rng.randn(B, Dp, L).astype(np.float32), rng.randn(B, Dp, L).astype(np.float32) * 0.2,
            -np.exp(rng.randn(Dp, N).astype(np.float32) * 0.2), rng.randn(B, G, N, L).astype(np.float32),
            rng.randn(B, G, N, L).astype(np.float32), rng.randn(Dp).astype(np.float32),
            rng.randn(Dp).astype(np.float32) * 0.1]
    want = np.asarray(jax.jit(jmamba.selective_scan)(*map(jnp.asarray, args)))
    got = mamba.selective_scan(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == (B, Dp, L)
    _close(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_vss_block_matches_jax(seed):
    jcfg = jmamba.SS2DConfig(d_model=32, d_state=4, expand=2.0)
    p = jax.tree.map(np.asarray, _init(jax.random.PRNGKey(seed), jcfg))
    # a livelier block than the init's 0.02 weights: every parameter perturbed
    rng = np.random.RandomState(seed)
    p = jax.tree.map(lambda a: (a + rng.randn(*a.shape) * 0.1).astype(np.float32), p)
    x = np.random.RandomState(seed + 1).randn(2, 8, 8, 32).astype(np.float32)
    want = np.asarray(_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg))
    block = mamba.VSSBlock(mamba.SS2DConfig(d_model=32, d_state=4, expand=2.0))
    block.load_state_dict(vss_block_state_dict(p), strict=True)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    _close(got, want)


def test_init_matches_jax_init_statistics():
    cfg = mamba.SS2DConfig(d_model=32, d_state=4, expand=2.0)
    block = mamba.init_vss_block_(mamba.VSSBlock(cfg), seed=0)
    want = vss_block_state_dict(jax.tree.map(np.asarray, _init(
        jax.random.PRNGKey(0), jmamba.SS2DConfig(d_model=32, d_state=4, expand=2.0))))
    got = block.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape, k
        if k.endswith(("bias", "A_logs", "Ds", "skip_scale", "skip_scale2")) or "ln_" in k or "out_norm" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, err_msg=k)
        else:   # random draws: the same scale
            assert 0.5 < float(got[k].std() / want[k].std()) < 2.0, k
