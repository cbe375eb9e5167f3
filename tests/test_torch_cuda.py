"""CUDA-only checks of the port's kernels (skipped without an NVIDIA GPU).

The CUDA kernels have no interpret mode, so their arithmetic is checked
here, on the card, against the plain versions the CPU tests hold to
catseg_tpu.  This file imports no jax; run it on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -q --noconftest``.
"""

import pytest
import torch

from catseg_tpu_torch.configs import eval_preset, vitb384
from catseg_tpu_torch.kernels import _build, class_layer, selfcheck

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA and Triton kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", [k[0] for k in selfcheck.KERNELS])
def test_kernel_matches_plain(cuda, name, dtype):
    case = selfcheck.cases(cuda, dtype, small=True)[name]
    before = _build.LAUNCHES[name]
    got = case.kernel()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] > before
    want = case.plain()
    assert got.shape == want.shape and got.dtype == want.dtype
    err, rel = selfcheck.rel_err(got, want)
    assert rel <= selfcheck.BOUND[dtype], (name, err, rel)


def test_launch_refuses_mixed_devices_and_strides(cuda):
    from catseg_tpu_torch.kernels import clip_attn

    q = torch.zeros(1, 65, 128, device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        clip_attn.fused_dense_attention(q, q.cpu(), q.cpu(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        _build.launch("catseg_dense_attention", q, q.transpose(1, 2))


def _flagship_agg(cuda, **kw):
    from catseg_tpu_torch.core.aggregator import Aggregator
    from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_

    cfg = eval_preset(vitb384(compute_dtype="float32", **kw))
    model = init_catseg_(CATSeg(cfg), 0)
    agg = model.agg.to(cuda).eval()
    assert isinstance(agg, Aggregator)
    return agg, cfg


def test_decoder_kernel_launches_on_cuda(cuda):
    """conv_decoder at the flagship geometry with cfg.fused_decoder launches
    the decoder kernel and matches the plain pair."""
    from catseg_tpu_torch.core.aggregator import conv_decoder

    agg, _ = _flagship_agg(cuda)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 3, 24, 24, 128, generator=g).to(cuda)
    guid = [torch.randn(1, 48, 48, 32, generator=g).to(cuda), torch.randn(1, 96, 96, 16, generator=g).to(cuda)]
    before = _build.LAUNCHES["decoder"]
    with torch.no_grad():
        got = conv_decoder(x, guid, agg, use_fused=True)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["decoder"] == before + 1
        want = conv_decoder(x, guid, agg, use_fused=False)
    assert _build.LAUNCHES["decoder"] == before + 1
    err, rel = selfcheck.rel_err(got, want)
    assert got.shape == (1, 3, 96, 96) and rel <= selfcheck.BOUND[torch.float32], (err, rel)


def test_topk_path_runs_on_cuda(cuda):
    """T > pad_len keeps pad_len classes through the kernels; the rest get -100."""
    from catseg_tpu_torch.core.aggregator import aggregator_forward

    agg, cfg = _flagship_agg(cuda, pad_len=4)
    g = torch.Generator().manual_seed(1)
    img = torch.randn(1, 24, 24, 512, generator=g).to(cuda)
    txt = torch.randn(1, 6, 1, 512, generator=g).to(cuda)
    guid = tuple(torch.randn(1, s, s, c, generator=g).to(cuda) for s, c in ((24, 512), (48, 256), (96, 128)))
    _build.reset_launches()
    with torch.no_grad():
        logits, classes = aggregator_forward(agg, img, txt, guid, cfg, return_classes=True)
        full = aggregator_forward(agg, img, txt, guid, cfg)
    torch.cuda.synchronize()
    assert logits.shape == (1, 4, 96, 96) and classes.shape == (1, 4)
    assert _build.LAUNCHES["class_layer"] > 0 and _build.LAUNCHES["decoder"] > 0
    dropped = sorted(set(range(6)) - set(classes[0].tolist()))
    assert (full[0, dropped] == -100.0).all()
    # two runs: the decoder kernel sums GroupNorm statistics with atomics, in
    # an order that changes from run to run
    torch.testing.assert_close(full[0, classes[0]], logits[0], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_class_layer_takes_256_and_raises_at_257(cuda, dtype):
    assert class_layer.MAX_CLASSES == 256
    C = 128
    g = torch.Generator().manual_seed(2)
    cp = {k: (torch.randn(*s, generator=g) * 0.05).to(cuda) for k, s in (
        ("ln1_g", (C,)), ("ln1_b", (C,)), ("q_w", (2 * C, C)), ("q_b", (C,)), ("k_w", (2 * C, C)),
        ("k_b", (C,)), ("v_w", (C, C)), ("v_b", (C,)), ("ln2_g", (C,)), ("ln2_b", (C,)),
        ("mlp1_w", (C, 4 * C)), ("mlp1_b", (4 * C,)), ("mlp2_w", (4 * C, C)), ("mlp2_b", (C,)))}
    pkv, pks = torch.zeros(C, C, device=cuda), torch.zeros(1, C, device=cuda)
    for T in (256, 257):
        x = torch.randn(1, T, 4, 4, C, generator=g).to(cuda, dtype)
        run = lambda: class_layer.fused_class_layer(x, None, None, pkv, pks, cp, 4, T)  # noqa: E731
        if T == 257:
            with pytest.raises(NotImplementedError, match="at most 256"):
                run()
            continue
        got = run()
        torch.cuda.synchronize()
        want = class_layer.class_layer_plain(x, None, None, pkv, pks, cp, 4, T)
        assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[dtype]
