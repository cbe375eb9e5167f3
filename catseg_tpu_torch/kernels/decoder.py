"""The guidance-conditioned decoder (both Up stages + head): CUDA kernel +
plain PyTorch version.

Replaces catseg_tpu/kernels/decoder.py:fused_decoder (Pallas ``_kernel`` /
``_slab_forward``, forward only).  Per (image, class) slab x (24, 24, 128):
ConvT k2s2 128 -> 96, conv3x3 96 -> 64 + the image's guidance plane, GN(4) +
ReLU, conv3x3 64 -> 64, GN(4) + ReLU at 48^2; ConvT 64 -> 48, conv3x3 48 -> 32
+ guidance plane, GN(2) + ReLU, conv3x3 32 -> 32, GN(2) + ReLU at 96^2; conv3x3
32 -> 1 + bias -> fp32 (96, 96) logits.  Conv1 of each stage splits as
conv(concat(u, g)) == conv_u(u) + conv_g(g): the guidance half runs once per
image here, in plain PyTorch, as the reference's ``_prep_guidance`` runs
outside its Pallas call.  The kernel (csrc/decoder.cu) takes the flagship
geometry only (:func:`decoder_kernel_applicable`); its note there says what
bounds it on the card.

The plain version is the reference's ``_up_tail`` pair (core/aggregator.py
there): the wrapper takes it only for CPU tensors.  Parameter dicts hold the
reference checkpoint's torch layouts: ``up_w`` (Cin, Cout, 2, 2), ``up_b``,
``conv1_w`` (mid, Cin, 3, 3), ``gn1_g/b``, ``conv2_w`` (mid, mid, 3, 3),
``gn2_g/b``; head ``w`` (1, C, 3, 3), ``b`` (1,).
"""

from __future__ import annotations

import torch

from ..ops import conv2d, conv_transpose2d_nonoverlap, group_norm
from . import _build

BASE = 24   # feature grid the kernel is written for


def _double_conv(x: torch.Tensor, dp: dict, guidances: tuple) -> torch.Tensor:
    """conv3x3 -> GN(mid/16) -> ReLU, twice; each per-image guidance's share of
    the first conv runs once per image and broadcasts over the classes."""
    w1 = dp["conv1_w"]
    mid, Cx = w1.shape[0], x.shape[-1]
    h = conv2d(x, w1[:, :Cx], None, padding=1)
    ofs = Cx
    for g in guidances:
        Cg = g.shape[-1]
        hg = conv2d(g.to(x.dtype), w1[:, ofs:ofs + Cg], None, padding=1)
        h = (h.reshape(hg.shape[0], -1, *h.shape[1:]) + hg[:, None]).reshape(h.shape)
        ofs += Cg
    x = torch.relu(group_norm(h, mid // 16, dp["gn1_g"], dp["gn1_b"]))
    x = conv2d(x, dp["conv2_w"], None, padding=1)
    return torch.relu(group_norm(x, mid // 16, dp["gn2_g"], dp["gn2_b"]))


def up_tail(x: torch.Tensor, guidances: tuple, dp: dict, head: dict | None) -> torch.Tensor:
    """ConvT(k2 s2) -> DoubleConv [-> head conv]: (N, H, W, Cin) -> (N, 2H, 2W,
    mid), or fp32 (N, 2H, 2W) logits when ``head`` is given."""
    x = conv_transpose2d_nonoverlap(x, dp["up_w"], dp["up_b"], kernel=2)
    h = _double_conv(x, dp, guidances)
    if head is not None:
        return conv2d(h, head["w"], head["b"], padding=1)[..., 0].float()
    return h


def decoder_plain(x: torch.Tensor, g1, g2, d1: dict, d2: dict, head: dict) -> torch.Tensor:
    """x (N, 24, 24, C); g1 (B, 48, 48, Cg1) / g2 (B, 96, 96, Cg2) per-image
    guidance or None -> (N, 96, 96) fp32 logits."""
    h = up_tail(x, (g1,) if g1 is not None else (), d1, None)
    return up_tail(h, (g2,) if g2 is not None else (), d2, head)


def decoder_kernel_applicable(x: torch.Tensor, d1: dict, d2: dict) -> bool:
    """The reference's gate: 24^2 base, 128 channels in, decoder dims
    (96 -> 64) / (48 -> 32)."""
    return (tuple(x.shape[1:]) == (BASE, BASE, 128)
            and d1["up_w"].shape[1] == 96 and d1["conv1_w"].shape[0] == 64
            and d2["up_w"].shape[1] == 48 and d2["conv1_w"].shape[0] == 32)


def _guidance_half(dp: dict, g: torch.Tensor, cup: int, dt: torch.dtype) -> torch.Tensor:
    """conv1's per-image guidance half (B, H, W, mid) in the compute dtype."""
    w = dp["conv1_w"][:, cup:cup + g.shape[-1]]
    return conv2d(g.to(dt), w, None, padding=1).contiguous()


def _conv_taps(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (9 * Cin, Cout), row tap * Cin + ci, tap = dy * 3 + dx."""
    return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).to(dt).contiguous()


def _up_cols(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """(Cin, Cout, 2, 2) -> (Cin, 4 * Cout), column (a * 2 + b) * Cout + co."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).to(dt).contiguous()


def _decoder_cuda(x, g1, g2, d1, d2, head) -> torch.Tensor:
    N = x.shape[0]
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decoder kernel takes fp32 or bf16, got {dt}")
    if g1 is None or g2 is None or not decoder_kernel_applicable(x, d1, d2):
        raise NotImplementedError("decoder kernel is built for the flagship geometry with both "
                                  f"guidances; got x {tuple(x.shape)}")
    B = g1.shape[0]
    if N % B or g2.shape[0] != B:
        raise ValueError(f"{N} slabs do not split over {B} images")
    f32 = lambda v: v.float().reshape(-1).contiguous()  # noqa: E731
    hg1 = _guidance_half(d1, g1, 96, dt)
    hg2 = _guidance_half(d2, g2, 48, dt)
    if tuple(hg1.shape) != (B, 48, 48, 64) or tuple(hg2.shape) != (B, 96, 96, 32):
        raise ValueError(f"guidance planes {tuple(hg1.shape)}, {tuple(hg2.shape)}")
    w = [_up_cols(d1["up_w"], dt), f32(d1["up_b"]),
         _conv_taps(d1["conv1_w"][:, :96], dt), f32(d1["gn1_g"]), f32(d1["gn1_b"]),
         _conv_taps(d1["conv2_w"], dt), f32(d1["gn2_g"]), f32(d1["gn2_b"]),
         _up_cols(d2["up_w"], dt), f32(d2["up_b"]),
         _conv_taps(d2["conv1_w"][:, :48], dt), f32(d2["gn1_g"]), f32(d2["gn1_b"]),
         _conv_taps(d2["conv2_w"], dt), f32(d2["gn2_g"]), f32(d2["gn2_b"]),
         _conv_taps(head["w"], dt).reshape(-1), f32(head["b"])]
    x = x.contiguous()
    lib = _build.library()
    with torch.cuda.device(x.device):
        blocks = lib.catseg_decoder_blocks(int(dt == torch.bfloat16))
    if blocks <= 0:
        raise RuntimeError(f"decoder kernel: no resident CTA (cudaError {-blocks})")
    # a persistent grid: each CTA walks slabs with a private global scratch
    grid = min(N, blocks)
    scratch = torch.empty(grid * lib.catseg_decoder_scratch_elems(), dtype=dt, device=x.device)
    out = torch.empty((N, 96, 96), dtype=torch.float32, device=x.device)
    _build.launch("catseg_decoder", x, hg1, hg2, out, scratch, *w, N, N // B, grid,
                  int(dt == torch.bfloat16))
    _build.count("decoder")
    return out


def fused_decoder(x: torch.Tensor, g1: torch.Tensor, g2: torch.Tensor, d1: dict, d2: dict,
                  head: dict) -> torch.Tensor:
    """Both Up stages + head on x (B*T, 24, 24, 128) class slabs, image-major;
    g1 (B, 48, 48, Cg1), g2 (B, 96, 96, Cg2) -> (B*T, 96, 96) fp32 logits."""
    if x.is_cuda:
        return _decoder_cuda(x, g1, g2, d1, d2, head)
    if x.device.type == "cpu":
        return decoder_plain(x, g1, g2, d1, d2, head)
    raise RuntimeError(f"no decoder path for device {x.device}")
