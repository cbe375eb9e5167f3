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


def _misaligned(t):
    """t's values in a contiguous view that starts one element into its storage."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    assert v.is_contiguous() and v.data_ptr() % 16
    return v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", [k[0] for k in selfcheck.KERNELS])
def test_kernel_matches_plain(cuda, name, dtype):
    case = selfcheck.cases(cuda, dtype, small=True)[name]
    before = _build.LAUNCHES[name]
    got = case.kernel()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] > before
    want = case.plain()
    if isinstance(want, dict):   # gradients: the kernels return guidance cotangents in fp32
        assert all(got[k].shape == want[k].shape for k in want)
    else:
        assert got.shape == want.shape and got.dtype == want.dtype
    err, rel = selfcheck.rel_err(got, want)
    assert rel <= selfcheck.bound(name, dtype), (name, err, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", [k[0] for k in selfcheck.KERNELS if k[0].endswith("_bwd")])
def test_backward_kernel_is_deterministic(cuda, name, dtype):
    """Weight and guidance gradients are summed over CTAs through per-split
    partials in a fixed order (no atomics): two runs are bit-equal."""
    case = selfcheck.cases(cuda, dtype, small=True)[name]
    a, b = case.kernel(), case.kernel()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_small_train_step_trains_both_clip_towers(cuda):
    """One train step on the card: every forward and backward kernel runs,
    and the q/v projection weights of both CLIP towers get non-zero
    gradients (a kernel call outside its autograd Function would cut them)."""
    from catseg_tpu_torch import configs
    from catseg_tpu_torch.train.loop import class_tokens, init_train_state, train_loss
    from catseg_tpu_torch.core.clip import truncate_context

    cfg = configs.vitb384(clip=configs.CLIPVariant("mini-B/16", 16, 128, 3, 2, 64, 224, 128, 2, 2),
                          guidance_layers=(0, 1), guidance_proj_dim=128, text_guidance_dim=64,
                          appearance_guidance_dim=64, pad_len=8)
    state = init_train_state(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(truncate_context(class_tokens(configs.class_names("coco")[:6])).astype("int64"))
    g = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (2, 384, 384, 3), generator=g).to(cuda)
    targets = torch.randint(0, 6, (2, 384, 384), generator=g).to(cuda)
    _build.reset_launches()
    loss = train_loss(cfg, state.model, tokens.to(cuda), images, targets)
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert all(_build.LAUNCHES[k] > 0 for k in _build.FORWARD + _build.BACKWARD), dict(_build.LAUNCHES)
    assert not any(_build.LAUNCHES[k] for k in _build.UNFUSED), dict(_build.LAUNCHES)
    for tower in ("visual.transformer", "transformer"):
        for w in ("q_proj_weight", "v_proj_weight"):
            name = f"sem_seg_head.predictor.clip_model.{tower}.resblocks.0.attn.{w}"
            grad = dict(state.model.named_parameters())[name].grad
            assert grad is not None and grad.abs().max() > 0, name


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
    # two runs: the decoder kernel sums its GroupNorm statistics in a fixed
    # order (each warp's partials in its own slot), so they are bit-equal
    assert torch.equal(full[0, classes[0]], logits[0])


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


def test_full_attention_forward_runs_the_mlp_kernel(cuda):
    """attention_type="full" takes the unfused class stage on the card: the
    MLP kernel launches, the class-layer kernel never; the kept logits are
    finite."""
    from catseg_tpu_torch.core.aggregator import aggregator_forward

    agg, cfg = _flagship_agg(cuda, attention_type="full")
    g = torch.Generator().manual_seed(4)
    img = torch.randn(1, 24, 24, 512, generator=g).to(cuda)
    txt = torch.randn(1, 6, 1, 512, generator=g).to(cuda)
    guid = tuple(torch.randn(1, s, s, c, generator=g).to(cuda) for s, c in ((24, 512), (48, 256), (96, 128)))
    _build.reset_launches()
    with torch.no_grad():
        out = aggregator_forward(agg, img, txt, guid, cfg)
    torch.cuda.synchronize()
    assert out.shape == (1, 6, 96, 96) and torch.isfinite(out).all()
    assert _build.LAUNCHES["mlp"] > 0 and _build.LAUNCHES["class_layer"] == 0, dict(_build.LAUNCHES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_window_attention_takes_window_16(cuda, dtype):
    """256 tokens per window, the most the kernel takes: bf16 runs it on the
    tensor-core path (two 128-key halves, FlashAttention's order), fp32 on
    CUDA cores."""
    from catseg_tpu_torch.kernels import swin_block, window_attn

    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(8, 256, 128, generator=g).to(cuda, dtype) for _ in range(3))
    mask = swin_block.shift_mask(32, 32, 16, 8).to(cuda)
    assert window_attn.takes_tensor_cores(256, 128, 4, dtype) == (dtype == torch.bfloat16)
    before = _build.LAUNCHES["window_attention"]
    got = window_attn.fused_window_attention(q, k, v, mask, 4, 32 ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["window_attention"] == before + 1
    want = window_attn.window_attention_plain(q, k, v, mask, 4, 32 ** -0.5)
    assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("heads", [12, 16], ids=["W768", "W1024"])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 577])
def test_dense_attention_at_every_length(cuda, S, heads, dtype):
    """ViT-B (12 heads) and ViT-L (16) widths at lengths around the 64-key
    tile and CLIP's 577: the kernel launches, stays within the bound, and
    two runs are bit-equal."""
    from catseg_tpu_torch.kernels import clip_attn

    g = torch.Generator().manual_seed(S + heads)
    q, k, v = (torch.randn(2, S, 64 * heads, generator=g).to(cuda, dtype) for _ in range(3))
    before = _build.LAUNCHES["dense_attention"]
    got = clip_attn.fused_dense_attention(q, k, v, heads)
    again = clip_attn.fused_dense_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["dense_attention"] == before + 2
    want = clip_attn.dense_attention_plain(q, k, v, heads)
    assert got.shape == want.shape and got.dtype == dtype
    assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[dtype]
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_dense_attention_refuses_misaligned_rows(cuda, dtype):
    """The kernel reads rows by 16-byte copies: a contiguous view that starts
    16 bytes into its storage runs and equals a fresh copy; one that starts
    an element in raises before any launch."""
    from catseg_tpu_torch.kernels import clip_attn

    n = 2 * 65 * 128
    step = 16 // torch.tensor([], dtype=dtype).element_size()
    buf = torch.randn(n + step, generator=torch.Generator().manual_seed(5)).to(cuda, dtype)
    q = buf[step:].view(2, 65, 128)
    assert q.is_contiguous() and q.data_ptr() % 16 == 0
    got = clip_attn.fused_dense_attention(q, q, q, 2)
    assert torch.equal(got, clip_attn.fused_dense_attention(q.clone(), q.clone(), q.clone(), 2))
    odd = buf[1:n + 1].view(2, 65, 128)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    before = _build.LAUNCHES["dense_attention"]
    with pytest.raises(ValueError, match="16-byte"):
        clip_attn.fused_dense_attention(odd, odd, odd, 2)
    assert _build.LAUNCHES["dense_attention"] == before


def _window_case(cuda, N, D, dtype, seed):
    from catseg_tpu_torch.kernels import swin_block

    win = int(N ** 0.5)
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(8, N, 128, generator=g).to(cuda, dtype) for _ in range(3))
    return q, k, v, swin_block.shift_mask(2 * win, 2 * win, win, win // 2).to(cuda), 128 // D


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("N", [144, 256])
def test_window_attention_masks(cuda, N, D, dtype):
    """Windows 12 and 16 at head dims 16, 32, 64 and 128 (C = 128, so 128
    is one head; bf16 on tensor cores): the shift mask, a zero mask and no
    mask each launch the kernel within the bound; no mask is bit-equal to
    the zero mask, and two runs are bit-equal."""
    from catseg_tpu_torch.kernels import window_attn

    q, k, v, shifted, heads = _window_case(cuda, N, D, dtype, seed=N + D)
    assert window_attn.takes_tensor_cores(N, 128, heads, dtype) == (dtype == torch.bfloat16)
    scale = D ** -0.5
    out = {}
    for name, mask in (("shifted", shifted), ("zeros", torch.zeros_like(shifted)), ("none", None)):
        before = _build.LAUNCHES["window_attention"]
        out[name] = window_attn.fused_window_attention(q, k, v, mask, heads, scale)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["window_attention"] == before + 1, name
        want = window_attn.window_attention_plain(q, k, v, mask, heads, scale)
        assert selfcheck.rel_err(out[name], want)[1] <= selfcheck.BOUND[dtype], name
    assert torch.equal(out["zeros"], out["none"])
    assert torch.equal(out["shifted"], window_attn.fused_window_attention(q, k, v, shifted, heads, scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("N", [144, 256])
def test_window_attention_four_heads_of_128(cuda, N, dtype):
    """Hidden 512 at 4 heads of 128: K and V of a window exceed the shared
    memory (295 KB at 144 tokens), so both dtypes take the CUDA-core path;
    the shift mask launches the kernel once within the bound, two runs
    bit-equal."""
    from catseg_tpu_torch.kernels import swin_block, window_attn

    win = int(N ** 0.5)
    g = torch.Generator().manual_seed(N + 512)
    q, k, v = (torch.randn(8, N, 512, generator=g).to(cuda, dtype) for _ in range(3))
    mask = swin_block.shift_mask(2 * win, 2 * win, win, win // 2).to(cuda)
    assert window_attn.kernel_takes(N, 512, 4) and not window_attn.takes_tensor_cores(N, 512, 4, dtype)
    before = _build.LAUNCHES["window_attention"]
    got = window_attn.fused_window_attention(q, k, v, mask, 4, 128 ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["window_attention"] == before + 1
    want = window_attn.window_attention_plain(q, k, v, mask, 4, 128 ** -0.5)
    assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[dtype]
    assert torch.equal(got, window_attn.fused_window_attention(q, k, v, mask, 4, 128 ** -0.5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("guided", [False, True], ids=["views", "guided"])
def test_window_attention_takes_qkv_views(cuda, dtype, guided):
    """The unfused Swin block's q, k, v are views of its fused projection
    (rows 3C apart; with guidance q and k are fresh tensors, v a view): the
    kernel reads them in place, equal to the call on contiguous copies; a
    row stride off the 16-byte grid (132 elements) leaves the tensor cores
    for the CUDA-core path, launches once and stays within the bound."""
    from catseg_tpu_torch.kernels import swin_block, window_attn

    g = torch.Generator().manual_seed(8)
    qkv = torch.randn(2, 36, 144, 3 * 128, generator=g).to(cuda, dtype)
    q, k, v = (t.reshape(-1, 144, 128) for t in qkv.split(128, dim=-1))
    if guided:
        q, k = q + 0.5, k - 0.5
    assert v.stride(1) == 384 and not v.is_contiguous()
    mask = swin_block.shift_mask(24, 24, 12, 6).to(cuda)
    got = window_attn.fused_window_attention(q, k, v, mask, 4, 32 ** -0.5)
    want = window_attn.fused_window_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask, 4, 32 ** -0.5)
    assert torch.equal(got, want)
    odd = torch.randn(72, 144, 132, generator=g).to(cuda, dtype)[..., :128]
    assert odd.stride(1) == 132
    before = _build.LAUNCHES["window_attention"]
    got = window_attn.fused_window_attention(odd, odd, odd, mask, 4, 32 ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["window_attention"] == before + 1
    want = window_attn.window_attention_plain(odd, odd, odd, mask, 4, 32 ** -0.5)
    assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[dtype]


# (head dim, heads) of the window-attention head-dim tests: C up to 512 at
# the first heads of each head dim (ids the head dim alone), 48 and 96 also
# at 1 and 3 heads (the tensor-core path's padded K / V rows, C / 8 not a
# multiple of 8), and past 512 (640 at 4 heads of 160, 768 at 3 of 256)
FIRST_HEADS = {3: 32, 24: 4, 25: 4, 48: 4, 96: 4, 192: 2, 256: 1, 512: 1}
ANY_HEADS = [pytest.param(D, heads, id=str(D) if FIRST_HEADS.get(D) == heads else f"{D}x{heads}")
             for D, heads in (*FIRST_HEADS.items(), (48, 1), (48, 3), (96, 1), (96, 3), (160, 4), (256, 3))]


def _extra_seed(D, heads):
    """0 at the first heads of a head dim (the seeds those cases had), a
    seed of their own for the others."""
    return 0 if FIRST_HEADS.get(D) == heads else 1000 * heads


def _tc_smem(N, C):
    """The tensor-core path's shared memory for a window (tc_smem in
    csrc/window_attn.cu): K and V rows of C / 8 16-byte chunks, one chunk
    of padding where that count is not a multiple of 8."""
    chunks = C // 8 + (1 if (C // 8) % 8 else 0)
    return 2 * N * chunks * 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D,heads", ANY_HEADS)
@pytest.mark.parametrize("N", [49, 144, 256])
def test_window_attention_any_head_dim(cuda, N, D, heads, dtype):
    """Head dims outside 8-128 (3, 24, 25, 160, 192, 256, 512: the CUDA-core
    path) and 48 / 96 (bf16 on the tensor cores where N % 16 and the
    window's K and V fit the 227 KB opt-in, else that path), at widths up
    to 768 and windows 7, 12 and 16: the shift mask and no mask each launch
    the kernel once within the bound, and a second run is bit-equal."""
    from catseg_tpu_torch.kernels import swin_block, window_attn

    C, win = heads * D, int(N ** 0.5)
    g = torch.Generator().manual_seed(N + D + _extra_seed(D, heads))
    q, k, v = (torch.randn(8, N, C, generator=g).to(cuda, dtype) for _ in range(3))
    shifted = swin_block.shift_mask(2 * win, 2 * win, win, win // 2).to(cuda)
    assert window_attn.kernel_takes(N, C, heads)
    tc = dtype == torch.bfloat16 and D in (48, 96) and N % 16 == 0 and _tc_smem(N, C) <= 232448
    assert window_attn.takes_tensor_cores(N, C, heads, dtype) == tc
    for mask in (shifted, None):
        before = _build.LAUNCHES["window_attention"]
        got = window_attn.fused_window_attention(q, k, v, mask, heads, D ** -0.5)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["window_attention"] == before + 1
        want = window_attn.window_attention_plain(q, k, v, mask, heads, D ** -0.5)
        assert got.shape == want.shape and got.dtype == dtype
        assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[dtype], mask is None
        assert torch.equal(got, window_attn.fused_window_attention(q, k, v, mask, heads, D ** -0.5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D,heads", ANY_HEADS)
def test_window_attention_any_head_dim_qkv_views(cuda, D, heads, dtype):
    """The unfused Swin block's views of one qkv projection at those head
    dims (rows 3C apart: 300 elements at hidden 100, off the 16-byte grid):
    read in place, equal to the call on contiguous copies (the same path),
    one launch each, within the bound."""
    from catseg_tpu_torch.kernels import swin_block, window_attn

    C = heads * D
    g = torch.Generator().manual_seed(D + _extra_seed(D, heads))
    qkv = torch.randn(8, 144, 3 * C, generator=g).to(cuda, dtype)
    q, k, v = qkv.split(C, dim=-1)
    assert v.stride(1) == 3 * C and not v.is_contiguous()
    mask = swin_block.shift_mask(24, 24, 12, 6).to(cuda)
    before = _build.LAUNCHES["window_attention"]
    got = window_attn.fused_window_attention(q, k, v, mask, heads, D ** -0.5)
    want = window_attn.fused_window_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask, heads,
                                              D ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["window_attention"] == before + 2
    assert torch.equal(got, want)
    assert selfcheck.rel_err(got, window_attn.window_attention_plain(q, k, v, mask, heads, D ** -0.5))[1] \
        <= selfcheck.BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", [32, 64])
def test_mlp_kernel_takes_narrow_widths(cuda, dtype, C):
    """Hidden widths below the reference's 128-wide gate (its small
    aggregator configuration runs hidden 32) launch the kernel too, with a
    ragged last row tile."""
    from catseg_tpu_torch.kernels import mlp

    g = torch.Generator().manual_seed(6)
    x = torch.randn(333, C, generator=g).to(cuda, dtype)
    w1, b1 = (torch.randn(C, 4 * C, generator=g) * C ** -0.5).to(cuda), torch.randn(4 * C, generator=g).to(cuda)
    w2, b2 = (torch.randn(4 * C, C, generator=g) * (4 * C) ** -0.5).to(cuda), torch.randn(C, generator=g).to(cuda)
    for act in ("gelu", "relu"):
        before = _build.LAUNCHES["mlp"]
        got = mlp.fused_mlp(x, w1, b1, w2, b2, act)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["mlp"] == before + 1
        want = mlp.mlp_plain(x, w1, b1, w2, b2, act)
        assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[dtype], act


@pytest.mark.parametrize("attn", ["linear", "full"])
def test_small_geometry_runs_the_unfused_kernels(cuda, attn):
    """catseg_tpu's aggregator parity configuration (hidden 32, window 4, 8x8
    grid, pool 2, pad_len 8): every stage takes the unfused route, its
    kernels launch, and the fp32 result matches the port on the CPU within
    that test's 5e-4 abs and 1e-3 rel."""
    from catseg_tpu_torch.configs import CATSegConfig
    from catseg_tpu_torch.core import aggregator as A

    cfg = CATSegConfig(hidden_dim=32, num_heads=4, window_size=4, feature_resolution=(8, 8), pooling_size=(2, 2),
                       pad_len=8, appearance_guidance_dim=24, appearance_guidance_proj_dim=16, text_guidance_dim=48,
                       text_guidance_proj_dim=16, decoder_dims=(32, 16), decoder_guidance_dims=(24, 12),
                       decoder_guidance_proj_dims=(8, 4), num_layers=2, compute_dtype="float32", attention_type=attn)
    agg = A.Aggregator(cfg)
    agg.conv1 = A.Conv(2, cfg.hidden_dim, 7)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in agg.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    agg.eval()
    img, txt = torch.randn(2, 8, 8, 48, generator=g), torch.randn(2, 5, 2, 48, generator=g)
    guid = tuple(torch.randn(2, s, s, c, generator=g) for s, c in ((8, 24), (16, 24), (32, 12)))
    with torch.no_grad():
        want = A.aggregator_forward(agg, img, txt, guid, cfg)
        agg.to(cuda)
        _build.reset_launches()
        got = A.aggregator_forward(agg, img.to(cuda), txt.to(cuda), tuple(t.to(cuda) for t in guid), cfg)
        torch.cuda.synchronize()
    launched = {k for k, n in _build.LAUNCHES.items() if n}
    assert {"window_attention", "mlp"} <= launched and not launched & {"swin_block", "class_layer"}, launched
    assert ("linear_attention" in launched) == (attn == "linear"), launched
    torch.testing.assert_close(got.cpu(), want, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("name", list(selfcheck.ROUTES))
def test_routes_on_cuda_launch_or_raise(cuda, name):
    """The aggregator at geometries some kernels do not take (hidden 96,
    hidden 192 at 3 heads, ...) and at the widths they were widened to
    (hidden 256 and 512, one head, ...): where a kernel the routes call refuses the
    geometry where the reference's gate runs its kernel, the card raises
    NotImplementedError naming one of those kernels; elsewhere exactly the
    kernels the routes call and do not run plain launch (LayerNorm aside)
    and the fp32 logits match the port on the CPU within 5e-4 abs and 1e-3
    rel."""
    from catseg_tpu_torch.core import aggregator as A

    called, raises, plain = selfcheck.ROUTES[name][-3:]
    cfg, agg, (img, txt, guid) = selfcheck.route_aggregator(name)
    with torch.no_grad():
        want = A.aggregator_forward(agg, img, txt, guid, cfg)
        agg.to(cuda)
        run = lambda: A.aggregator_forward(agg, img.to(cuda), txt.to(cuda),  # noqa: E731
                                           tuple(t.to(cuda) for t in guid), cfg)
        if raises:
            with pytest.raises(NotImplementedError) as err:
                run()
            assert any(k.replace("_", " ") in str(err.value) for k in raises), err.value
            return
        _build.reset_launches()
        got = run()
        torch.cuda.synchronize()
    launched = {k for k, n in _build.LAUNCHES.items() if n}
    assert launched - {"layer_norm"} == called - plain, launched
    torch.testing.assert_close(got.cpu(), want, atol=5e-4, rtol=1e-3)


def test_single_image_api_on_cuda(cuda):
    """A small model on the whole-image branch: predict_argmax launches the
    forward kernels the branch reaches and matches the CPU port; probs_sliding
    is the batch path's row."""
    import copy

    import numpy as np

    from catseg_tpu_torch.core.catseg import CATSeg, init_catseg_
    from catseg_tpu_torch.infer.pipeline import Predictor

    cfg = vitb384(clip=selfcheck_clip(), compute_dtype="float32", guidance_layers=(0, 1), guidance_proj_dim=128,
                  text_guidance_dim=64, appearance_guidance_dim=64, pad_len=8)
    cpu_model = init_catseg_(CATSeg(cfg), 0).eval()
    text = torch.nn.functional.normalize(torch.randn(6, 1, 64, generator=torch.Generator().manual_seed(1)), dim=-1)
    cpu = Predictor(cpu_model, cfg, [str(i) for i in range(6)], text_feats=text, device="cpu")
    gpu = Predictor(copy.deepcopy(cpu_model), cfg, cpu.class_names, text_feats=text, device=cuda)
    img = np.random.RandomState(0).randint(0, 256, (120, 160, 3), dtype=np.uint8)
    _build.reset_launches()
    got = gpu.probs_whole(img)
    torch.cuda.synchronize()
    launched = {k for k, n in _build.LAUNCHES.items() if n}
    assert launched == set(_build.FORWARD), launched
    assert (got.cpu() - cpu.probs_whole(img)).abs().max().item() < 5e-4
    assert (gpu.predict_argmax(img) == cpu.predict_argmax(img)).mean() >= 0.999
    sliding = Predictor(gpu.model, eval_preset(cfg), cpu.class_names, text_feats=text, device=cuda)
    assert torch.equal(sliding.probs_sliding(img), sliding.probs_sliding_batch([img])[0])


def selfcheck_clip():
    """A 3-layer ViT-B/16-shaped CLIP (width 128, 2 heads of 64, embed 64)."""
    from catseg_tpu_torch.configs import CLIPVariant

    return CLIPVariant("mini-B/16", 16, 128, 3, 2, 64, 224, 128, 2, 2)


def _swin_params(g, cuda, C=128):
    def u(*shape, bound=None):
        bound = shape[0] ** -0.5 if bound is None else bound
        return ((torch.rand(*shape, generator=g) * 2 - 1) * bound).to(cuda)

    return {"ln1_g": 1 + u(C, bound=0.1), "ln1_b": u(C, bound=0.1), "qkv_w": u(C, 3 * C),
            "qkv_b": u(3 * C, bound=0.1), "proj_w": u(C, C), "proj_b": u(C, bound=0.1),
            "ln2_g": 1 + u(C, bound=0.1), "ln2_b": u(C, bound=0.1), "fc1_w": u(C, 4 * C),
            "fc1_b": u(4 * C, bound=0.1), "fc2_w": u(4 * C, C), "fc2_b": u(C, bound=0.1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("grid", [(24, 24), (24, 48)], ids=["24x24", "24x48"])
@pytest.mark.parametrize("T", [1, 5])
def test_swin_block_geometries(cuda, T, grid, shift, guided, dtype):
    """One Swin block (bf16: the tensor-core kernel; fp32: CUDA cores) on 2
    images x T classes over a 24 x 24 or a 24 x 48 grid, at shift 0 and 6,
    with and without guidance, against the plain block: 2^-5 (bf16) and
    1e-4 (fp32) of max(1, |plain|); the pair once too.  Two runs are
    bit-equal."""
    from catseg_tpu_torch.kernels import swin_block

    g = torch.Generator().manual_seed(T * 100 + grid[1] + shift)
    x = torch.randn(2, T, *grid, 128, generator=g).to(cuda, dtype)
    qg, kg = (None, None) if not guided else (
        (torch.randn(2, *grid, 128, generator=g) * 0.5).to(cuda, dtype) for _ in range(2))
    p = _swin_params(g, cuda)
    before = _build.LAUNCHES["swin_block"]
    got = swin_block._swin_block_cuda(x, qg, kg, p, shift)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["swin_block"] == before + 1
    want = swin_block.swin_block_plain(x, qg, kg, p, 4, 12, shift)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[dtype]
    assert torch.equal(got, swin_block._swin_block_cuda(x, qg, kg, p, shift))
    if shift == 6:
        guid4 = None if not guided else (qg, kg, kg, qg)
        p1 = _swin_params(g, cuda)
        pair = swin_block.fused_swin_pair(x, guid4, p1, p, 4, 12)
        assert selfcheck.rel_err(pair, swin_block.swin_pair_plain(x, guid4, p1, p, 4, 12))[1] <= selfcheck.BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", [512, 768, 1024])
def test_layer_norm_widths(cuda, C, dtype):
    """The text tower's, ViT-B's and ViT-L's row widths, 5771 rows (a
    grid-stride walk whose last step is ragged: 8 rows a block per step),
    against the plain LayerNorm within the bound; the launch count rises, in
    serving (no gradient) and under autograd alike."""
    from catseg_tpu_torch.kernels import layer_norm

    g = torch.Generator().manual_seed(C)
    x = (torch.randn(5771, C, generator=g) * 2 + 0.5).to(cuda, dtype)
    w, b = (1 + torch.randn(C, generator=g) * 0.1).to(cuda), (torch.randn(C, generator=g) * 0.1).to(cuda)
    want = layer_norm.layer_norm_plain(x, w, b)
    for grad in (False, True):
        before = _build.LAUNCHES["layer_norm"]
        with torch.set_grad_enabled(grad):
            got = layer_norm.fused_layer_norm(x.requires_grad_(grad), w, b)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["layer_norm"] == before + 1
        assert got.dtype == dtype and got.shape == x.shape
        assert selfcheck.rel_err(got.detach(), want)[1] <= selfcheck.BOUND[dtype], grad
        x = x.detach()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(7, 768), (511, 128), (600, 520), (1, 96)], ids=lambda s: "x".join(map(str, s)))
def test_layer_norm_launches_outside_the_reference_gate(cuda, shape, dtype):
    """Fewer than 512 rows, or a width not a multiple of 128: the reference's
    TPU gate would take its plain form; on the card the kernel launches and
    matches the plain LayerNorm within the bound."""
    from catseg_tpu_torch.kernels import layer_norm

    g = torch.Generator().manual_seed(shape[0] + shape[1])
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(cuda, dtype)
    w, b = (1 + torch.randn(shape[1], generator=g) * 0.1).to(cuda), (torch.randn(shape[1], generator=g) * 0.1).to(cuda)
    before = _build.LAUNCHES["layer_norm"]
    got = layer_norm.fused_layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["layer_norm"] == before + 1
    assert selfcheck.rel_err(got, layer_norm.layer_norm_plain(x, w, b))[1] <= selfcheck.BOUND[dtype]


def test_layer_norm_refuses_what_it_cannot_take(cuda):
    """A width the kernel does not take where the reference's gate runs its
    kernel (512 rows of 4224 in bf16, of 2176 in fp32: past 4096 / 2048),
    and rows that start off a 16-byte boundary, raise before any launch;
    a width the kernel does not take where that gate fails (64 rows of 6 in
    bf16) runs the plain version, as the reference runs its plain
    composition, and launches nothing."""
    from catseg_tpu_torch.kernels import layer_norm

    before = _build.LAUNCHES["layer_norm"]
    for C, dtype in ((4224, torch.bfloat16), (2176, torch.float32)):
        assert layer_norm.route(C, 512, dtype) == "raise"
        w, b = torch.ones(C, device=cuda), torch.zeros(C, device=cuda)
        with pytest.raises(NotImplementedError, match="layer_norm kernel"):
            layer_norm.fused_layer_norm(torch.randn(512, C, device=cuda, dtype=dtype), w, b)
    w, b = torch.ones(768, device=cuda), torch.zeros(768, device=cuda)
    x6 = torch.randn(64, 6, device=cuda, dtype=torch.bfloat16)
    assert layer_norm.route(6, 64, torch.bfloat16) == "plain"
    assert torch.equal(layer_norm.fused_layer_norm(x6, w[:6], b[:6]), layer_norm.layer_norm_plain(x6, w[:6], b[:6]))
    buf = torch.randn(8 * 768 + 8, device=cuda, dtype=torch.bfloat16)
    odd = buf[1:8 * 768 + 1].view(8, 768)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        layer_norm.fused_layer_norm(odd, w, b)
    assert _build.LAUNCHES["layer_norm"] == before
    ok = buf[8:].view(8, 768)
    assert torch.equal(layer_norm.fused_layer_norm(ok, w, b), layer_norm.fused_layer_norm(ok.clone(), w, b))


@pytest.mark.parametrize("grad", [False, True], ids=["serving", "autograd"])
def test_layer_norm_runs_plain_outside_the_reference_gate(cuda, grad):
    """bf16 rows of 100 (the hidden-100 aggregator's LayerNorms): the kernel
    does not take the width and the reference's gate (C % 128) fails, so
    the card runs layer_norm_plain, bit-equal, in serving and under
    autograd, and launches nothing."""
    from catseg_tpu_torch.kernels import layer_norm

    g = torch.Generator().manual_seed(100)
    x = (torch.randn(4 * 576, 100, generator=g) * 2 + 0.5).to(cuda, torch.bfloat16)
    w, b = (1 + torch.randn(100, generator=g) * 0.1).to(cuda), (torch.randn(100, generator=g) * 0.1).to(cuda)
    assert layer_norm.route(100, 4 * 576, torch.bfloat16) == "plain"
    _build.reset_launches()
    with torch.set_grad_enabled(grad):
        got = layer_norm.fused_layer_norm(x.requires_grad_(grad), w, b)
    torch.cuda.synchronize()
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    assert torch.equal(got.detach(), layer_norm.layer_norm_plain(x.detach(), w, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_swin_block_refuses_misaligned_rows(cuda, dtype):
    """The bf16 kernel gathers token rows by 16-byte copies: an x or a
    guidance view that starts one element into its storage raises before
    any launch (in both dtypes, one check)."""
    from catseg_tpu_torch.kernels import swin_block

    g = torch.Generator().manual_seed(11)
    n = 24 * 24 * 128
    buf = torch.randn(n + 1, generator=g).to(cuda, dtype)
    odd = buf[1:].view(1, 1, 24, 24, 128)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    good = buf[:n].view(1, 1, 24, 24, 128)
    gd = good[:, 0]
    p = _swin_params(g, cuda)
    before = _build.LAUNCHES["swin_block"]
    for x, qg, kg in ((odd, None, None), (good, odd[:, 0], gd), (good, gd, odd[:, 0])):
        with pytest.raises(ValueError, match="16-byte"):
            swin_block._swin_block_cuda(x, qg, kg, p, 0)
    assert _build.LAUNCHES["swin_block"] == before


def _class_params(g, cuda, C=128):
    def u(*shape, bound=None):
        bound = shape[0] ** -0.5 if bound is None else bound
        return ((torch.rand(*shape, generator=g) * 2 - 1) * bound).to(cuda)

    return {"ln1_g": 1 + u(C, bound=0.1), "ln1_b": u(C, bound=0.1), "q_w": u(2 * C, C), "q_b": u(C),
            "k_w": u(2 * C, C), "k_b": u(C), "v_w": u(C, C), "v_b": u(C), "ln2_g": 1 + u(C, bound=0.1),
            "ln2_b": u(C, bound=0.1), "mlp1_w": u(C, 4 * C), "mlp1_b": u(4 * C), "mlp2_w": u(4 * C, C),
            "mlp2_b": u(C)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("grid", [4, 24], ids=["4x4", "24x24"])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("T", [1, 5, 150, 256])
def test_class_layer_geometries(cuda, T, B, grid, guided, dtype):
    """One class layer (bf16: the tensor-core kernel, rows padded to 16;
    fp32: CUDA cores) on B images x T classes over a 4 x 4 or a 24 x 24 grid,
    with and without guidance, pad_len 256, against the plain layer: 2^-5
    (bf16) and 1e-4 (fp32) of max(1, |plain|).  The launch count rises by
    one and two runs are bit-equal."""
    C, Tp = 128, 256
    g = torch.Generator().manual_seed(T * 10 + B + grid)
    cp = _class_params(g, cuda)
    x = torch.randn(B, T, grid, grid, C, generator=g).to(cuda, dtype)
    qg, kg = (None, None) if not guided else (
        (torch.randn(B, T, C, generator=g) * 0.3).to(cuda, dtype) for _ in range(2))
    pkv, pks = class_layer.pad_contributions(torch.randn(C, generator=g).to(cuda),
                                             torch.randn(C, generator=g).to(cuda), cp, Tp - T, Tp, 4)
    before = _build.LAUNCHES["class_layer"]
    got = class_layer.fused_class_layer(x, qg, kg, pkv, pks, cp, 4, Tp)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["class_layer"] == before + 1
    want = class_layer.class_layer_plain(x, qg, kg, pkv, pks, cp, 4, Tp)
    assert got.dtype == want.dtype and got.shape == want.shape
    err, rel = selfcheck.rel_err(got, want)
    assert rel <= selfcheck.BOUND[dtype], (err, rel)
    assert torch.equal(got, class_layer.fused_class_layer(x, qg, kg, pkv, pks, cp, 4, Tp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_class_layer_refuses_misaligned_rows(cuda, dtype):
    """The bf16 kernel reads class rows by 16-byte copies: an x or a guidance
    view that starts one element into its storage raises before any launch
    (in both dtypes, one check)."""
    C = 128
    g = torch.Generator().manual_seed(12)
    cp = _class_params(g, cuda)
    n = 5 * 4 * 4 * C
    buf = torch.randn(n + 1, generator=g).to(cuda, dtype)
    odd, good = buf[1:].view(1, 5, 4, 4, C), buf[:n].view(1, 5, 4, 4, C)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    gbuf = torch.randn(5 * C + 1, generator=g).to(cuda, dtype)
    godd, ggood = gbuf[1:].view(1, 5, C), gbuf[:5 * C].view(1, 5, C)
    pkv, pks = torch.zeros(C, C, device=cuda), torch.zeros(1, C, device=cuda)
    before = _build.LAUNCHES["class_layer"]
    for x, qg, kg in ((odd, None, None), (good, godd, ggood), (good, ggood, godd)):
        with pytest.raises(ValueError, match="16-byte"):
            class_layer.fused_class_layer(x, qg, kg, pkv, pks, cp, 4, 8)
    assert _build.LAUNCHES["class_layer"] == before


def _decoder_inputs(g, cuda, images, T, dtype):
    def u(*shape, bound):
        return ((torch.rand(*shape, generator=g) * 2 - 1) * bound).to(cuda)

    def up(cin, cup, mid):
        return {"up_w": u(cin, cup, 2, 2, bound=(4 * cin) ** -0.5), "up_b": u(cup, bound=0.05),
                "conv1_w": u(mid, cin, 3, 3, bound=(9 * cin) ** -0.5),
                "gn1_g": 1 + u(mid, bound=0.1), "gn1_b": u(mid, bound=0.1),
                "conv2_w": u(mid, mid, 3, 3, bound=(9 * mid) ** -0.5),
                "gn2_g": 1 + u(mid, bound=0.1), "gn2_b": u(mid, bound=0.1)}

    d1, d2 = up(128, 96, 64), up(64, 48, 32)
    head = {"w": u(1, 32, 3, 3, bound=(9 * 32) ** -0.5), "b": u(1, bound=0.1)}
    x = torch.randn(images * T, 24, 24, 128, generator=g).to(cuda, dtype)
    g1 = (torch.randn(images, 48, 48, 32, generator=g) * 0.5).to(cuda, dtype)
    g2 = (torch.randn(images, 96, 96, 16, generator=g) * 0.5).to(cuda, dtype)
    return x, g1, g2, d1, d2, head


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("images,T", [(1, 5), (3, 45)], ids=["1x5", "3x45"])
def test_decoder_slab_counts(cuda, images, T, dtype):
    """The decoder kernel on 1 image x 5 classes and on 3 images x 45 (135
    slabs: the persistent grid of one CTA an SM does not divide them evenly
    on a 132-SM card) against the plain decoder: 2^-5 (bf16) and 1e-4 (fp32)
    of max(1, |plain|); the launch count rises by one."""
    from catseg_tpu_torch.kernels import decoder

    g = torch.Generator().manual_seed(images * 100 + T)
    x, g1, g2, d1, d2, head = _decoder_inputs(g, cuda, images, T, dtype)
    before = _build.LAUNCHES["decoder"]
    got = decoder.fused_decoder(x, g1, g2, d1, d2, head)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decoder"] == before + 1
    want = decoder.decoder_plain(x, g1, g2, d1, d2, head)
    assert got.shape == want.shape == (images * T, 96, 96) and got.dtype == torch.float32
    err, rel = selfcheck.rel_err(got, want)
    assert rel <= selfcheck.BOUND[dtype], (err, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_decoder_is_deterministic(cuda, dtype):
    """GroupNorm sums go through per-warp slots in a fixed order, no atomics:
    two runs on one input (140 slabs over 2 images) are bit-equal."""
    from catseg_tpu_torch.kernels import decoder

    g = torch.Generator().manual_seed(21)
    x, g1, g2, d1, d2, head = _decoder_inputs(g, cuda, 2, 70, dtype)
    a = decoder.fused_decoder(x, g1, g2, d1, d2, head)
    b = decoder.fused_decoder(x, g1, g2, d1, d2, head)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_decoder_refuses_misaligned_rows(cuda, dtype):
    """The bf16 kernel reads slabs by 16-byte copies: an x or a guidance plane
    that starts one element into its storage raises before any launch (in
    both dtypes, one check)."""
    from catseg_tpu_torch.kernels import decoder

    g = torch.Generator().manual_seed(13)
    x, g1, g2, d1, d2, head = _decoder_inputs(g, cuda, 1, 2, dtype)
    p = dict(zip(decoder._DK, decoder._params(d1, d2, head)))
    hg1, hg2 = decoder._guidance_half(d1, g1, 96, dtype), decoder._guidance_half(d2, g2, 48, dtype)

    before = _build.LAUNCHES["decoder"]
    with pytest.raises(ValueError, match="16-byte"):
        decoder.fused_decoder(_misaligned(x), g1, g2, d1, d2, head)
    for a, b in ((_misaligned(hg1), hg2), (hg1, _misaligned(hg2))):
        with pytest.raises(ValueError, match="16-byte"):
            decoder._decoder_cuda(x, a, b, p)
    assert _build.LAUNCHES["decoder"] == before


@pytest.mark.parametrize("images,T", [(1, 1), (1, 5), (3, 15)], ids=["1", "5", "45"])
def test_decoder_backward_slab_counts(cuda, images, T):
    """The bf16 decoder backward (tensor cores) on 1, 5 and 45 slabs (1 and 3
    images; 45 spreads unevenly over the weight grads' 128 K splits)
    against the plain backward within selfcheck's bound on every gradient;
    the launch count rises by one and a rerun is bit-equal."""
    from catseg_tpu_torch.kernels import decoder

    dt = torch.bfloat16
    g = torch.Generator().manual_seed(images * 1000 + T)
    x, g1, g2, d1, d2, head = _decoder_inputs(g, cuda, images, T, dt)
    p = dict(zip(decoder._DK, decoder._params(d1, d2, head)))
    hg1, hg2 = decoder._guidance_half(d1, g1, 96, dt), decoder._guidance_half(d2, g2, 48, dt)
    dout = torch.randn(images * T, 96, 96, generator=g).to(cuda)
    names = ("dx", "dhg1", "dhg2")
    before = _build.LAUNCHES["decoder_bwd"]
    got = selfcheck._grads(names, decoder.decoder_backward(x, hg1, hg2, dout, p))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["decoder_bwd"] == before + 1
    want = selfcheck._grads(names, decoder.decoder_backward_plain(x, hg1, hg2, dout, p))
    err, rel = selfcheck.rel_err(got, want)
    assert rel <= selfcheck.bound("decoder_bwd", dt), (err, rel)
    again = selfcheck._grads(names, decoder.decoder_backward(x, hg1, hg2, dout, p))
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("shift", [0, 6])
@pytest.mark.parametrize("grid", [(24, 24), (24, 48)], ids=["24x24", "24x48"])
@pytest.mark.parametrize("T", [1, 5])
def test_swin_block_backward_geometries(cuda, T, grid, shift, guided):
    """The bf16 Swin block backward (tensor cores) on 2 images x T classes
    over a 24 x 24 or a 24 x 48 grid, at shift 0 and 6, with and without
    guidance, against the plain backward within selfcheck's bound on every
    gradient; the launch count rises by one and a rerun is bit-equal."""
    from catseg_tpu_torch.kernels import swin_block

    dt = torch.bfloat16
    g = torch.Generator().manual_seed(T * 100 + grid[1] + shift + 7 * guided)
    x = torch.randn(2, T, *grid, 128, generator=g).to(cuda, dt)
    qg, kg = (None, None) if not guided else (
        (torch.randn(2, *grid, 128, generator=g) * 0.5).to(cuda, dt) for _ in range(2))
    dout = torch.randn(2, T, *grid, 128, generator=g).to(cuda, dt)
    p = _swin_params(g, cuda)
    names = ("dx", "dqg", "dkg")
    before = _build.LAUNCHES["swin_block_bwd"]
    got = selfcheck._grads(names, swin_block.swin_block_backward(x, qg, kg, dout, p, 4, 12, shift))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["swin_block_bwd"] == before + 1
    want = selfcheck._grads(names, swin_block.swin_block_backward_plain(x, qg, kg, dout, p, 4, 12, shift))
    err, rel = selfcheck.rel_err(got, want)
    assert rel <= selfcheck.bound("swin_block_bwd", dt), (err, rel)
    again = selfcheck._grads(names, swin_block.swin_block_backward(x, qg, kg, dout, p, 4, 12, shift))
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_backward_kernels_refuse_misaligned_rows(cuda, dtype):
    """The bf16 backward kernels read rows by 16-byte copies: an input that
    starts one element into its storage raises a ValueError before any
    launch, for the decoder (x, hg1, hg2) and the Swin block (x, dout, qg,
    kg), in both dtypes (one check)."""
    from catseg_tpu_torch.kernels import decoder, swin_block

    g = torch.Generator().manual_seed(14)
    x, g1, g2, d1, d2, head = _decoder_inputs(g, cuda, 1, 2, dtype)
    p = dict(zip(decoder._DK, decoder._params(d1, d2, head)))
    hg1, hg2 = decoder._guidance_half(d1, g1, 96, dtype), decoder._guidance_half(d2, g2, 48, dtype)
    dout = torch.randn(2, 96, 96, generator=g).to(cuda)
    before = _build.LAUNCHES["decoder_bwd"]
    for args in ((_misaligned(x), hg1, hg2), (x, _misaligned(hg1), hg2), (x, hg1, _misaligned(hg2))):
        with pytest.raises(ValueError, match="16-byte"):
            decoder.decoder_backward(*args, dout, p)
    assert _build.LAUNCHES["decoder_bwd"] == before
    xs = torch.randn(1, 2, 24, 24, 128, generator=g).to(cuda, dtype)
    gs = torch.randn(1, 24, 24, 128, generator=g).to(cuda, dtype)
    ds = torch.randn(1, 2, 24, 24, 128, generator=g).to(cuda, dtype)
    ps = _swin_params(g, cuda)
    before = _build.LAUNCHES["swin_block_bwd"]
    for args in ((_misaligned(xs), gs, gs, ds), (xs, gs, gs, _misaligned(ds)), (xs, _misaligned(gs), gs, ds),
                 (xs, gs, _misaligned(gs), ds)):
        with pytest.raises(ValueError, match="16-byte"):
            swin_block.swin_block_backward(*args, ps, 4, 12, 0)
    assert _build.LAUNCHES["swin_block_bwd"] == before


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("grid", [12, 24, 5], ids=["12x12", "24x24", "5x5"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("T", [5, 171, 256])
def test_class_layer_backward_geometries(cuda, T, B, grid, guided):
    """The bf16 class-layer backward (tensor cores) on B images x T classes
    over the train step's 12 x 12 pooled grid, a 24 x 24 one and a 5 x 5 one
    (125 class rows at B 1, T 5: products over a batch-row count that is no
    multiple of 8), with and without guidance, pad_len 256, against the
    plain backward within selfcheck's bound on every gradient; the launch
    count rises by one and a rerun is bit-equal."""
    dt, C, Tp = torch.bfloat16, 128, 256
    g = torch.Generator().manual_seed(T * 100 + B * 10 + grid + guided)
    cp = _class_params(g, cuda)
    x = torch.randn(B, T, grid, grid, C, generator=g).to(cuda, dt)
    qg, kg = (None, None) if not guided else (
        (torch.randn(B, T, C, generator=g) * 0.3).to(cuda, dt) for _ in range(2))
    pkv, pks = class_layer.pad_contributions(torch.randn(C, generator=g).to(cuda),
                                             torch.randn(C, generator=g).to(cuda), cp, Tp - T, Tp, 4)
    dout = torch.randn(B, T, grid, grid, C, generator=g).to(cuda, dt)
    kp = class_layer.kernel_params(cp)
    names = ("dx", "dqg", "dkg", "dpad_kv", "dpad_ksum")
    before = _build.LAUNCHES["class_layer_bwd"]
    got = selfcheck._grads(names, class_layer.class_layer_backward(x, qg, kg, pkv, pks, dout, kp, 4, Tp))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["class_layer_bwd"] == before + 1
    want = selfcheck._grads(names, class_layer.class_layer_backward_plain(x, qg, kg, pkv, pks, dout, kp, 4, Tp))
    err, rel = selfcheck.rel_err(got, want)
    assert rel <= selfcheck.bound("class_layer_bwd", dt), (err, rel)
    again = selfcheck._grads(names, class_layer.class_layer_backward(x, qg, kg, pkv, pks, dout, kp, 4, Tp))
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_class_layer_backward_refuses_misaligned_dout(cuda, dtype):
    """The bf16 class-layer backward reads dout's class rows by 16-byte
    copies: a dout that starts one element into its storage raises a
    ValueError before any launch (in both dtypes, one check)."""
    C = 128
    g = torch.Generator().manual_seed(15)
    kp = class_layer.kernel_params(_class_params(g, cuda))
    x = torch.randn(1, 5, 12, 12, C, generator=g).to(cuda, dtype)
    buf = torch.randn(x.numel() + 1, generator=g).to(cuda, dtype)
    dout = buf[1:].view(x.shape)
    assert dout.is_contiguous() and dout.data_ptr() % 16
    pkv, pks = torch.zeros(C, C, device=cuda), torch.zeros(1, C, device=cuda)
    before = _build.LAUNCHES["class_layer_bwd"]
    with pytest.raises(ValueError, match="16-byte"):
        class_layer.class_layer_backward(x, None, None, pkv, pks, dout, kp, 4, 8)
    assert _build.LAUNCHES["class_layer_bwd"] == before


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("Co", [32, 64, 128, 256, 384, 512])
@pytest.mark.parametrize("C", [32, 128, 256, 384, 512])
def test_mlp_kernel_geometries(cuda, C, Co, act):
    """The bf16 MLP kernel at input widths 32, 128 (the model's, its k loop
    unrolled), 256, 384 and 512 and every output width (up to 256 both: 256-
    or 128-row tiles, the hidden in registers; past 256 either: 64-row tiles,
    the hidden through shared memory, the k loop unrolled at C = Co = 384
    and 512), both activations, on a ragged 1000 rows, against mlp_plain
    within 2^-5 of max(1, |plain|); the launch count rises by one."""
    from catseg_tpu_torch.kernels import mlp

    dt, H = torch.bfloat16, 4 * C
    g = torch.Generator().manual_seed(C + Co + (act == "gelu"))
    x = torch.randn(1000, C, generator=g).to(cuda, dt)
    w1, b1 = (torch.randn(C, H, generator=g) * C ** -0.5).to(cuda), (torch.randn(H, generator=g) * 0.1).to(cuda)
    w2, b2 = (torch.randn(H, Co, generator=g) * H ** -0.5).to(cuda), (torch.randn(Co, generator=g) * 0.1).to(cuda)
    before = _build.LAUNCHES["mlp"]
    got = mlp.fused_mlp(x, w1, b1, w2, b2, act)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mlp"] == before + 1
    want = mlp.mlp_plain(x, w1, b1, w2, b2, act)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[dt]


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("C", [384, 512])
def test_mlp_fp32_at_hidden_384_and_512(cuda, C, act):
    """The fp32 MLP kernel (CUDA cores; three or four output columns a
    thread) at C -> 4C -> C for C = 384 and 512, on a ragged 1000 rows,
    against mlp_plain within 1e-4 of max(1, |plain|)."""
    from catseg_tpu_torch.kernels import mlp

    H = 4 * C
    g = torch.Generator().manual_seed(C + (act == "gelu"))
    x = torch.randn(1000, C, generator=g).to(cuda)
    w1, b1 = (torch.randn(C, H, generator=g) * C ** -0.5).to(cuda), (torch.randn(H, generator=g) * 0.1).to(cuda)
    w2, b2 = (torch.randn(H, C, generator=g) * H ** -0.5).to(cuda), (torch.randn(C, generator=g) * 0.1).to(cuda)
    before = _build.LAUNCHES["mlp"]
    got = mlp.fused_mlp(x, w1, b1, w2, b2, act)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["mlp"] == before + 1
    want = mlp.mlp_plain(x, w1, b1, w2, b2, act)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_mlp_refuses_past_512_channels(cuda, dtype):
    """At C = 640 (640 -> 1536 -> 640, inside the reference's gate at 1024
    rows: C * H < 2^20) the call raises NotImplementedError naming the
    kernel, and nothing launches."""
    from catseg_tpu_torch.kernels import mlp

    C, H = 640, 1536
    assert mlp.route(C, H, C, 1024) == "raise"
    g = torch.Generator().manual_seed(64)
    x = torch.randn(1024, C, generator=g).to(cuda, dtype)
    w1, b1 = (torch.randn(C, H, generator=g) * C ** -0.5).to(cuda), torch.zeros(H, device=cuda)
    w2, b2 = (torch.randn(H, C, generator=g) * H ** -0.5).to(cuda), torch.zeros(C, device=cuda)
    _build.reset_launches()
    with pytest.raises(NotImplementedError, match="mlp kernel"):
        mlp.fused_mlp(x, w1, b1, w2, b2, "gelu")
    torch.cuda.synchronize()
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_mlp_refuses_misaligned_rows(cuda, dtype):
    """The bf16 MLP kernel lands x rows and weight chunks by 16-byte
    cp.async: an x or a weight that starts one element into its storage
    raises a ValueError before any launch (in both dtypes, one check)."""
    from catseg_tpu_torch.kernels import mlp

    g = torch.Generator().manual_seed(16)
    C, H = 128, 512

    x = torch.randn(64, C, generator=g).to(cuda, dtype)
    w1, b1 = (torch.randn(C, H, generator=g) * C ** -0.5).to(cuda, dtype), torch.zeros(H, device=cuda)
    w2, b2 = (torch.randn(H, C, generator=g) * H ** -0.5).to(cuda, dtype), torch.zeros(C, device=cuda)
    before = _build.LAUNCHES["mlp"]
    for args in ((_misaligned(x), w1, w2), (x, _misaligned(w1), w2), (x, w1, _misaligned(w2))):
        with pytest.raises(ValueError, match="16-byte"):
            mlp.fused_mlp(args[0], args[1], b1, args[2], b2, "relu")
    assert _build.LAUNCHES["mlp"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B", [1, 10])
@pytest.mark.parametrize("T", [1, 150, 171, 256])
@pytest.mark.parametrize("E", [40, 48, 512])
@pytest.mark.parametrize("C", [128, 256, 384])
def test_corr_embed_geometries(cuda, C, E, T, B, dtype):
    """Class counts that fill a CTA's 8 classes or not (171 leaves 3), one
    image or ten, one to three 128-channel blocks, text widths a multiple of
    32 or not (40, 48: a last k step with one or two lanes' runs inside E):
    one launch a call, two runs bit-equal, the plain version within the
    stated bound."""
    from catseg_tpu_torch.kernels import corr_embed

    g = torch.Generator().manual_seed(T + B + C + E)
    img = torch.randn(B, 24, 24, E, generator=g).to(cuda, dtype)
    txt = corr_embed.l2_normalize(torch.randn(B, T, 1, E, generator=g)).to(cuda, dtype)
    w = ((torch.rand(7, 7, 1, C, generator=g) * 2 - 1) / 7).to(cuda)
    b = ((torch.rand(C, generator=g) * 2 - 1) / 7).to(cuda)
    before = _build.LAUNCHES["corr_embed"]
    got = corr_embed.fused_corr_embed(img, txt, w, b)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["corr_embed"] == before + 1
    assert torch.equal(got, corr_embed.fused_corr_embed(img, txt, w, b))
    want = corr_embed.corr_embed_plain(img, txt, w, b)
    assert got.shape == want.shape == (B, T, 24, 24, C) and got.dtype == want.dtype
    assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_corr_embed_refuses_what_it_cannot_take(cuda, dtype):
    """E not a multiple of 8 (44) and C not a multiple of 128 (192) raise
    NotImplementedError, an image or text view not 16-byte aligned a
    ValueError, all before any launch."""
    from catseg_tpu_torch.kernels import corr_embed

    g = torch.Generator().manual_seed(3)
    w, b = torch.zeros(7, 7, 1, 128, device=cuda), torch.zeros(128, device=cuda)
    img = torch.randn(1, 24, 24, 512, generator=g).to(cuda, dtype)
    txt = corr_embed.l2_normalize(torch.randn(1, 5, 1, 512, generator=g)).to(cuda, dtype)
    before = _build.LAUNCHES["corr_embed"]
    with pytest.raises(NotImplementedError):
        corr_embed.fused_corr_embed(img[..., :44], txt[..., :44], w, b)
    with pytest.raises(NotImplementedError):
        corr_embed.fused_corr_embed(img, txt, torch.zeros(7, 7, 1, 192, device=cuda), torch.zeros(192, device=cuda))
    for args in ((_misaligned(img), txt), (img, _misaligned(txt))):
        with pytest.raises(ValueError, match="16-byte"):
            corr_embed.fused_corr_embed(*args, w, b)
    assert _build.LAUNCHES["corr_embed"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("D", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("S", [13, 150, 256])
def test_linear_attention_geometries(cuda, S, D, dtype):
    """Every head dim at C = 128, ragged and whole 32-row tiles, an odd
    number of sequences: one launch a call, two runs bit-equal, the plain
    version within the stated bound."""
    from catseg_tpu_torch.kernels import linear_attn

    g = torch.Generator().manual_seed(S + D)
    q, k, v = (torch.randn(7, S, 128, generator=g).to(cuda, dtype) for _ in range(3))
    before = _build.LAUNCHES["linear_attention"]
    got = linear_attn.fused_linear_attention(q, k, v, 128 // D)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["linear_attention"] == before + 1
    assert torch.equal(got, linear_attn.fused_linear_attention(q, k, v, 128 // D))
    want = linear_attn.linear_attention_plain(q, k, v, 128 // D)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,heads", [(16, 2), (32, 4), (96, 3), (256, 4), (512, 8), (512, 4)])
def test_linear_attention_widths(cuda, C, heads, dtype):
    """Widths below one CTA's 128 channels (one to six warps) and above it
    (two and four CTAs a sequence; hidden 512 at head dims 64 and 128)."""
    from catseg_tpu_torch.kernels import linear_attn

    g = torch.Generator().manual_seed(C)
    q, k, v = (torch.randn(5, 40, C, generator=g).to(cuda, dtype) for _ in range(3))
    got = linear_attn.fused_linear_attention(q, k, v, heads)
    want = linear_attn.linear_attention_plain(q, k, v, heads)
    assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[dtype]


# (C, heads) of the linear-attention head-dim tests: head dims 96, 24, 48,
# 256, 512, 192, 384, 3, 1, 12, 6, 4 and 2 (the CUDA-core path)
ANY_LINEAR = [(384, 4), (384, 16), (384, 8), (256, 1), (512, 1), (384, 2), (384, 1), (384, 128), (512, 512),
              (384, 32), (384, 64), (512, 128), (256, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,heads", ANY_LINEAR, ids=[f"C{c}-h{h}" for c, h in ANY_LINEAR])
@pytest.mark.parametrize("S", [13, 150, 256])
def test_linear_attention_any_head_dim(cuda, S, C, heads, dtype):
    """Every head dim at C a multiple of 128 up to 512 that the tensor-core
    path does not take (heads straddling its 128-channel chunk, or a D x D
    KV past a CTA): one launch a call, two runs bit-equal, the plain version
    within the stated bound."""
    from catseg_tpu_torch.kernels import linear_attn

    assert linear_attn.route(C, heads, S) == "kernel"
    g = torch.Generator().manual_seed(S + C + heads)
    q, k, v = (torch.randn(5, S, C, generator=g).to(cuda, dtype) for _ in range(3))
    before = _build.LAUNCHES["linear_attention"]
    got = linear_attn.fused_linear_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["linear_attention"] == before + 1
    assert torch.equal(got, linear_attn.fused_linear_attention(q, k, v, heads))
    want = linear_attn.linear_attention_plain(q, k, v, heads)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert selfcheck.rel_err(got, want)[1] <= selfcheck.BOUND[dtype]


def test_linear_attention_refuses_what_it_cannot_take(cuda):
    """A head dim of 1024 at C = 1024 and S = 16 (past the widths the kernel
    takes at every head dim, where the reference's gate runs its kernel)
    raises NotImplementedError, a view not 16-byte aligned a ValueError,
    before any launch."""
    from catseg_tpu_torch.kernels import linear_attn

    before = _build.LAUNCHES["linear_attention"]
    y = torch.zeros(2, 16, 128, device=cuda)
    wide = torch.zeros(2, 16, 1024, device=cuda)
    assert linear_attn.route(1024, 1, 16) == "raise"
    with pytest.raises(NotImplementedError):
        linear_attn.fused_linear_attention(wide, wide, wide, 1)
    with pytest.raises(ValueError, match="16-byte"):
        linear_attn.fused_linear_attention(_misaligned(y), y, y, 4)
    assert _build.LAUNCHES["linear_attention"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,heads,S", [(8, 1, 16), (192, 3, 16), (1024, 1, 13)])
def test_linear_attention_runs_plain_outside_the_reference_gate(cuda, C, heads, S, dtype):
    """Outside the kernel's geometry and the reference's gate (C % 128, S %
    8), the card runs the plain version, as the reference runs its own
    plain composition there: the result equals linear_attention_plain and
    nothing launches."""
    from catseg_tpu_torch.kernels import linear_attn

    assert linear_attn.route(C, heads, S) == "plain"
    g = torch.Generator().manual_seed(C + S)
    q, k, v = (torch.randn(3, S, C, generator=g).to(cuda, dtype) for _ in range(3))
    _build.reset_launches()
    got = linear_attn.fused_linear_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    assert torch.equal(got, linear_attn.linear_attention_plain(q, k, v, heads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,H,Co,M", [(192, 768, 192, 2000), (128, 512, 96, 500), (640, 1536, 640, 100)])
def test_mlp_runs_plain_outside_the_reference_gate(cuda, C, H, Co, M, dtype):
    """Outside the kernel's geometry and the reference's gate (C and H
    multiples of 128, >= 1024 rows, C * H <= 2^20), the card runs the plain
    version: equal to mlp_plain, nothing launched; and hidden 640 at 1100
    rows (inside that gate) raises."""
    from catseg_tpu_torch.kernels import mlp

    assert mlp.route(C, H, Co, M) == "plain"
    g = torch.Generator().manual_seed(C + Co)
    x = torch.randn(M, C, generator=g).to(cuda, dtype)
    w1, b1 = (torch.randn(C, H, generator=g) * C ** -0.5).to(cuda), torch.randn(H, generator=g).to(cuda)
    w2, b2 = (torch.randn(H, Co, generator=g) * H ** -0.5).to(cuda), torch.randn(Co, generator=g).to(cuda)
    _build.reset_launches()
    got = mlp.fused_mlp(x, w1, b1, w2, b2, "gelu")
    torch.cuda.synchronize()
    assert not any(_build.LAUNCHES.values()), _build.LAUNCHES
    assert torch.equal(got, mlp.mlp_plain(x, w1, b1, w2, b2, "gelu"))
    if C == 640:
        with pytest.raises(NotImplementedError, match="mlp kernel"):
            mlp.fused_mlp(x.repeat(11, 1), w1, b1, w2, b2, "gelu")
