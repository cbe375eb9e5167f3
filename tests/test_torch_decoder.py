"""The port's decoder module (kernels/decoder.py) against catseg_tpu's, on the CPU.

The port's plain decoder (what its wrapper runs for CPU tensors, and what
csrc/decoder.cu is held to on the card) is fed the same numpy inputs as
catseg_tpu's fused decoder, which runs as tests/test_decoder_kernel.py runs
it here (Pallas interpret mode), and as its plain-XLA reference
``_xla_reference``.  B = 1 image, T = 2 classes at the flagship decoder
geometry (24^2 x 128 in, decoder dims 96 -> 64, 48 -> 32), fp32.
Tolerance 1e-4 abs: summation order only (the kernel's group statistics
are E[x^2] - mean^2, the port's F.group_norm two-pass).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catseg_tpu.kernels import decoder as jdec

from catseg_tpu_torch.core.aggregator import conv_decoder
from catseg_tpu_torch.kernels import decoder as tdec


def _jax_params(seed=0):
    """Decoder parameters in catseg_tpu's layouts (HWIO convs, (Cin, 2, 2, Cout) ConvT)."""
    rng = np.random.RandomState(seed)
    u = lambda bound, *s: rng.uniform(-bound, bound, s).astype(np.float32)  # noqa: E731

    def up(cin, cup, mid):
        return {"up_w": u((4 * cin) ** -0.5, cin, 2, 2, cup), "up_b": u(0.05, cup),
                "conv1_w": u((9 * cin) ** -0.5, 3, 3, cin, mid),
                "gn1": {"g": 1 + u(0.1, mid), "b": u(0.1, mid)},
                "conv2_w": u((9 * mid) ** -0.5, 3, 3, mid, mid),
                "gn2": {"g": 1 + u(0.1, mid), "b": u(0.1, mid)}}

    head = {"w": u((9 * 32) ** -0.5, 3, 3, 32, 1), "b": u(0.1, 1)}
    return up(128, 96, 64), up(64, 48, 32), head


def _port(dp):
    """catseg_tpu layouts -> the port's (torch checkpoint) layouts."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return {"up_w": t(dp["up_w"].transpose(0, 3, 1, 2)), "up_b": t(dp["up_b"]),
            "conv1_w": t(dp["conv1_w"].transpose(3, 2, 0, 1)),
            "gn1_g": t(dp["gn1"]["g"]), "gn1_b": t(dp["gn1"]["b"]),
            "conv2_w": t(dp["conv2_w"].transpose(3, 2, 0, 1)),
            "gn2_g": t(dp["gn2"]["g"]), "gn2_b": t(dp["gn2"]["b"])}


def _inputs(B=1, T=2, seed=1):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B * T, 24, 24, 128) * 0.5).astype(np.float32)
    g1 = (rng.randn(B, 48, 48, 32) * 0.5).astype(np.float32)
    g2 = (rng.randn(B, 96, 96, 16) * 0.5).astype(np.float32)
    return x, g1, g2


@pytest.fixture(scope="module")
def case():
    d1, d2, head = _jax_params()
    x, g1, g2 = _inputs()
    got = tdec.fused_decoder(torch.from_numpy(x), torch.from_numpy(g1), torch.from_numpy(g2),
                             _port(d1), _port(d2),
                             {"w": torch.from_numpy(np.ascontiguousarray(head["w"].transpose(3, 2, 0, 1))),
                              "b": torch.from_numpy(head["b"])})
    return (d1, d2, head), (x, g1, g2), got


def test_plain_decoder_matches_pallas(case):
    (d1, d2, head), (x, g1, g2), got = case
    want = jdec.fused_decoder(jnp.asarray(x), jnp.asarray(g1), jnp.asarray(g2), d1, d2, head, 1, 2)
    assert got.shape == (2, 96, 96) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_plain_decoder_matches_xla_reference(case):
    (d1, d2, head), (x, g1, g2), got = case
    want = jdec._xla_reference(jnp.asarray(x), jnp.asarray(g1), jnp.asarray(g2), d1, d2, head, 1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("geometry", [
    ((24, 24, 128), (96, 64), (48, 32)),   # the flagship: the kernel's geometry
    ((24, 24, 96), (96, 64), (48, 32)),    # another hidden width
    ((32, 32, 128), (96, 64), (48, 32)),   # another feature grid
    ((24, 24, 128), (112, 64), (48, 32)),  # other decoder dims
    ((24, 24, 128), (96, 64), (48, 16)),
], ids=["flagship", "hidden96", "grid32", "dec1", "dec2"])
def test_decoder_kernel_applicable_mirrors_reference(geometry):
    (h, w, c), (cup1, mid1), (cup2, mid2) = geometry
    jd1 = {"up_w": np.zeros((c, 2, 2, cup1)), "conv1_w": np.zeros((3, 3, c, mid1))}
    jd2 = {"up_w": np.zeros((mid1, 2, 2, cup2)), "conv1_w": np.zeros((3, 3, mid1, mid2))}
    want = jdec.decoder_kernel_applicable(np.zeros((1, h, w, c)), jd1, jd2)
    got = tdec.decoder_kernel_applicable(torch.zeros(1, h, w, c),
                                         {k: torch.from_numpy(v.transpose(0, 3, 1, 2) if k == "up_w"
                                                              else v.transpose(3, 2, 0, 1))
                                          for k, v in jd1.items()},
                                         {k: torch.from_numpy(v.transpose(0, 3, 1, 2) if k == "up_w"
                                                              else v.transpose(3, 2, 0, 1))
                                          for k, v in jd2.items()})
    assert got == want == (geometry[0] == (24, 24, 128) and geometry[1:] == ((96, 64), (48, 32)))


@pytest.mark.parametrize("use_fused", [True, False], ids=["fused", "plain"])
def test_conv_decoder_routes_on_cpu(case, use_fused):
    """On the CPU the aggregator's decoder gives the plain pair's logits
    whether or not the config asks for the fused kernel."""
    from catseg_tpu_torch.configs import vitb384
    from catseg_tpu_torch.core.aggregator import Aggregator

    (d1, d2, head), (x, g1, g2), want = case
    agg = Aggregator(vitb384())
    with torch.no_grad():
        for up, dp in ((agg.decoder1, _port(d1)), (agg.decoder2, _port(d2))):
            for name, p in up.packed().items():
                p.copy_(dp[name])
        agg.head.weight.copy_(torch.from_numpy(np.ascontiguousarray(head["w"].transpose(3, 2, 0, 1))))
        agg.head.bias.copy_(torch.from_numpy(head["b"]))
        got = conv_decoder(torch.from_numpy(x)[None], [torch.from_numpy(g1), torch.from_numpy(g2)], agg,
                           use_fused=use_fused)
    assert got.shape == (1, 2, 96, 96)
    torch.testing.assert_close(got[0], want, atol=0, rtol=0)
