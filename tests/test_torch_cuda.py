"""CUDA-only checks of the port's kernels (skipped without an NVIDIA GPU).

The CUDA kernels have no interpret mode, so their arithmetic is checked
here, on the card, against the plain versions the CPU tests hold to
catseg_tpu.  This file imports no jax; run it on a GPU machine with
``python -m pytest tests/test_torch_cuda.py -q --noconftest``.
"""

import pytest
import torch

from catseg_tpu_torch.configs import eval_preset, vitb384
from catseg_tpu_torch.kernels import _build, selfcheck

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
    kernel, plain = selfcheck.cases(cuda, dtype, small=True)[name]
    before = _build.LAUNCHES[name]
    got = kernel()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] > before
    want = plain()
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


def test_fused_decoder_raises_on_cuda(cuda):
    from catseg_tpu_torch.core.aggregator import conv_decoder

    x = torch.zeros(1, 1, 24, 24, 128, device=cuda)
    with pytest.raises(NotImplementedError, match="fused decoder"):
        conv_decoder(x, [None, None], None, use_fused=True)


def test_topk_path_raises(cuda):
    from catseg_tpu_torch.core.aggregator import aggregator_forward

    cfg = eval_preset(vitb384(pad_len=4))
    with pytest.raises(NotImplementedError, match="top-k"):
        aggregator_forward(None, None, torch.zeros(1, 5, 1, 512, device=cuda), (), cfg)
