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
geometry only (:func:`decoder_kernel_applicable`).  In bf16 it runs every
conv, ConvT and the head on mma.sync tensor cores over double-buffered
cp.async bands, its weights packed 16 rows deep in fragment order
(:func:`pack_mma_b`), at about 6x its tensor-core bound on an H100: the
per-CTA scratch planes (~7 MB a slab, beyond the L2) and the latency inside
each stage hold it there; its note there says more.  GroupNorm sums go through per-warp slots
in a fixed order, so two runs are bit-equal.

The plain version is the reference's ``_up_tail`` pair (core/aggregator.py
there): the wrapper takes it only for CPU tensors.  Parameter dicts hold the
reference checkpoint's torch layouts: ``up_w`` (Cin, Cout, 2, 2), ``up_b``,
``conv1_w`` (mid, Cin, 3, 3), ``gn1_g/b``, ``conv2_w`` (mid, mid, 3, 3),
``gn2_g/b``; head ``w`` (1, C, 3, 3), ``b`` (1,).

Gradients: the fused call is a ``torch.autograd.Function`` over x, the two
per-image guidance planes (conv1's guidance halves, computed outside it by
``F.conv2d``, so autograd carries their gradients into ``conv1_w[:, Cup:]``
and the guidance, as the reference's ``_prep_guidance_w``) and the torch-
layout parameters.  Its backward on CUDA is csrc/decoder_bwd.cu (replaces
the reference's ``_fused_bwd``; in bf16 on mma.sync tensor cores, every
fp32 cotangent a product reads as a bf16 pair hi + lo, its note there says
more); on the CPU autograd through the plain version.
"""

from __future__ import annotations

import torch

from ..ops import conv2d, conv_transpose2d_nonoverlap, group_norm
from . import _build
from .autograd import plain_vjp
from .swin_block import pack_mma_b

BASE = 24   # feature grid the kernel is written for


def _double_conv(x: torch.Tensor, dp: dict, planes: tuple) -> torch.Tensor:
    """conv3x3 -> GN(mid/16) -> ReLU, twice; each per-image guidance plane
    (a slice of conv1 over one guidance, :func:`guidance_planes`) broadcasts
    over the classes."""
    w1 = dp["conv1_w"]
    mid = w1.shape[0]
    h = conv2d(x, w1[:, :x.shape[-1]], None, padding=1)
    for plane in planes:
        h = (h.reshape(plane.shape[0], -1, *h.shape[1:]) + plane[:, None]).reshape(h.shape)
    x = torch.relu(group_norm(h, mid // 16, dp["gn1_g"], dp["gn1_b"]))
    x = conv2d(x, dp["conv2_w"], None, padding=1)
    return torch.relu(group_norm(x, mid // 16, dp["gn2_g"], dp["gn2_b"]))


def up_tail(x: torch.Tensor, planes: tuple, dp: dict, head: dict | None) -> torch.Tensor:
    """ConvT(k2 s2) -> DoubleConv [-> head conv]: (N, H, W, Cin) -> (N, 2H, 2W,
    mid), or fp32 (N, 2H, 2W) logits when ``head`` is given."""
    x = conv_transpose2d_nonoverlap(x, dp["up_w"], dp["up_b"], kernel=2)
    h = _double_conv(x, dp, planes)
    if head is not None:
        return conv2d(h, head["w"], head["b"], padding=1)[..., 0].float()
    return h


def guidance_planes(dp: dict, guidances, dt: torch.dtype) -> tuple:
    """conv1's per-image guidance halves of a stage, one for each guidance
    (B, H, W, Cg) given (None skipped), over conv1's input channels after
    the ConvT's, in turn (the reference's ``_double_conv(x, dp, guidances)``;
    the fusion decoder passes two pyramids' guidance)."""
    planes, ofs = [], dp["up_w"].shape[1]
    for g in guidances:
        if g is not None:
            planes.append(_guidance_half(dp, g, ofs, dt))
            ofs += g.shape[-1]
    return tuple(planes)


def _decoder_planes(x: torch.Tensor, hg1, hg2, d1: dict, d2: dict, head: dict) -> torch.Tensor:
    """decoder_plain with the guidance planes given."""
    return up_tail(up_tail(x, (hg1,), d1, None), (hg2,), d2, head)


def decoder_plain(x: torch.Tensor, g1, g2, d1: dict, d2: dict, head: dict) -> torch.Tensor:
    """x (N, 24, 24, C); g1 (B, 48, 48, Cg1) / g2 (B, 96, 96, Cg2) per-image
    guidance or None -> (N, 96, 96) fp32 logits."""
    h = up_tail(x, guidance_planes(d1, (g1,), x.dtype), d1, None)
    return up_tail(h, guidance_planes(d2, (g2,), x.dtype), d2, head)


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


# the Function's parameters, torch layouts; c11 / c21 are conv1's x halves
_DK = ("up1_w", "up1_b", "c11_w", "gn11_g", "gn11_b", "c12_w", "gn12_g", "gn12_b",
       "up2_w", "up2_b", "c21_w", "gn21_g", "gn21_b", "c22_w", "gn22_g", "gn22_b", "hd_w", "hd_b")


def _params(d1: dict, d2: dict, head: dict) -> list:
    out = []
    for d, cup in ((d1, 96), (d2, 48)):
        out += [d["up_w"], d["up_b"], d["conv1_w"][:, :cup], d["gn1_g"], d["gn1_b"], d["conv2_w"],
                d["gn2_g"], d["gn2_b"]]
    return out + [head["w"], head["b"]]


def _check_cuda(x, g1, g2, d1, d2) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decoder kernel takes fp32 or bf16, got {x.dtype}")
    if g1 is None or g2 is None or not decoder_kernel_applicable(x, d1, d2):
        raise NotImplementedError("decoder kernel is built for the flagship geometry with both "
                                  f"guidances; got x {tuple(x.shape)}")
    if x.shape[0] % g1.shape[0] or g2.shape[0] != g1.shape[0]:
        raise ValueError(f"{x.shape[0]} slabs do not split over {g1.shape[0]} images")


def _kernel_weights(p: dict, dt: torch.dtype, f32: bool) -> list:
    """The kernel's layouts: ConvT (Cin, 4 Cout) columns, conv taps (9 Cin,
    Cout); matrices in dt (or fp32 rounded through dt), vectors fp32.  The
    bf16 kernel takes its ConvT and conv matrices packed in mma fragment
    order, 16 rows deep (:func:`pack_mma_b`; 9 x 48 rows are no multiple of
    32), the head's (288, 1) taps padded with zero columns to one n8 tile."""
    tc = dt == torch.bfloat16 and not f32
    pack = (lambda w: pack_mma_b(w, 16)) if tc else torch.Tensor.contiguous  # noqa: E731
    mat = (lambda w: w.to(dt).float().contiguous()) if f32 else (lambda w: w.to(dt).contiguous())  # noqa: E731
    vec = lambda v: v.float().reshape(-1).contiguous()  # noqa: E731
    out = []
    for s in (1, 2):
        out += [pack(mat(_up_cols(p[f"up{s}_w"], dt))), vec(p[f"up{s}_b"]), pack(mat(_conv_taps(p[f"c{s}1_w"], dt))),
                vec(p[f"gn{s}1_g"]), vec(p[f"gn{s}1_b"]), pack(mat(_conv_taps(p[f"c{s}2_w"], dt))),
                vec(p[f"gn{s}2_g"]), vec(p[f"gn{s}2_b"])]
    hd = _conv_taps(p["hd_w"], dt)
    hd = pack(torch.nn.functional.pad(mat(hd), (0, 7))) if tc else mat(hd.reshape(-1))
    return out + [hd, vec(p["hd_b"])]


def decoder_args(x, hg1, hg2, p: dict) -> tuple[torch.Tensor, tuple]:
    """(out, the arguments of C entry point ``catseg_decoder``) for the
    fused decoder on CUDA tensors: weights cast (and in bf16 packed) as the
    kernel takes them, the persistent grid and its scratch allocated."""
    N = x.shape[0]
    dt = x.dtype
    B = hg1.shape[0]
    hg1, hg2 = hg1.to(dt).contiguous(), hg2.to(dt).contiguous()
    if tuple(hg1.shape) != (B, 48, 48, 64) or tuple(hg2.shape) != (B, 96, 96, 32):
        raise ValueError(f"guidance planes {tuple(hg1.shape)}, {tuple(hg2.shape)}")
    w = _kernel_weights(p, dt, f32=False)
    x = x.contiguous()
    # the bf16 kernel reads x by 16-byte cp.async, the guidance planes by channel pairs
    _check_rows_aligned(x=x, hg1=hg1, hg2=hg2)
    lib = _build.library()
    with torch.cuda.device(x.device):
        blocks = lib.catseg_decoder_blocks(int(dt == torch.bfloat16))
    if blocks <= 0:
        raise RuntimeError(f"decoder kernel: no resident CTA (cudaError {-blocks})")
    # a persistent grid: each CTA walks slabs with a private global scratch
    grid = min(N, blocks)
    scratch = torch.empty(grid * lib.catseg_decoder_scratch_elems(), dtype=dt, device=x.device)
    out = torch.empty((N, 96, 96), dtype=torch.float32, device=x.device)
    return out, (x, hg1, hg2, out, scratch, *w, N, N // B, grid, int(dt == torch.bfloat16))


def _decoder_cuda(x, hg1, hg2, p: dict) -> torch.Tensor:
    out, args = decoder_args(x, hg1, hg2, p)
    _build.launch("catseg_decoder", *args)
    _build.count("decoder")
    return out


def _from_cols(g: torch.Tensor, cout: int) -> torch.Tensor:
    """(Cin, 4 Cout) ConvT columns -> (Cin, Cout, 2, 2)."""
    return g.reshape(g.shape[0], 2, 2, cout).permute(0, 3, 1, 2)


def _from_taps(g: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """(9 Cin, Cout) conv taps -> (Cout, Cin, 3, 3)."""
    return g.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)


def _check_rows_aligned(**ts) -> None:
    """The bf16 kernels read slabs by 16-byte copies: raise for a view that
    does not start 16-byte aligned (in both dtypes, one check)."""
    if any(t.data_ptr() % 16 for t in ts.values()):
        raise ValueError(f"decoder kernels read slabs by 16-byte copies: {', '.join(ts)} must start 16-byte "
                         f"aligned; got addresses mod 16 {[t.data_ptr() % 16 for t in ts.values()]}")


def _decoder_bwd_cuda(x, hg1, hg2, dout, p: dict):
    N = x.shape[0]
    dt = x.dtype
    B = hg1.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    x, dout = x.contiguous(), dout.float().contiguous()
    hg1, hg2 = hg1.to(dt).contiguous(), hg2.to(dt).contiguous()
    _check_rows_aligned(x=x, hg1=hg1, hg2=hg2)
    w = _kernel_weights(p, dt, f32=True)
    dx = torch.empty_like(x)
    dhg1, dhg2 = torch.empty((B, 48, 48, 64), **f32), torch.empty((B, 96, 96, 32), **f32)
    shapes = [(129, 384), (96,), (864, 64), (128,), (576, 64), (128,),
              (65, 192), (48,), (432, 32), (64,), (288, 32), (64,), (289,)]
    g = [torch.empty(s, **f32) for s in shapes]
    ws = torch.empty(_build.library().catseg_decoder_bwd_workspace(N, int(dt == torch.bfloat16)), **f32)
    _build.launch("catseg_decoder_bwd", x, hg1, hg2, dout, dx, dhg1, dhg2, *g, *w, ws, N, N // B,
                  int(dt == torch.bfloat16))
    _build.count("decoder_bwd")
    up1, up1b, c11, gn11, c12, gn12, up2, up2b, c21, gn21, c22, gn22, hd = g
    grads = {"up1_w": _from_cols(up1[:128], 96), "up1_b": up1b, "c11_w": _from_taps(c11, 96, 64),
             "gn11_g": gn11[:64], "gn11_b": gn11[64:], "c12_w": _from_taps(c12, 64, 64),
             "gn12_g": gn12[:64], "gn12_b": gn12[64:],
             "up2_w": _from_cols(up2[:64], 48), "up2_b": up2b, "c21_w": _from_taps(c21, 48, 32),
             "gn21_g": gn21[:32], "gn21_b": gn21[32:], "c22_w": _from_taps(c22, 32, 32),
             "gn22_g": gn22[:32], "gn22_b": gn22[32:],
             "hd_w": _from_taps(hd[:288, None], 32, 1), "hd_b": hd[288:]}
    return dx, dhg1, dhg2, grads


def _unpack(params) -> tuple[dict, dict, dict]:
    """The Function's flat parameters (``_DK``) as decoder_plain's (d1, d2,
    head); conv1 holds only its x half."""
    p = dict(zip(_DK, params))
    d1, d2 = ({"up_w": p[f"up{s}_w"], "up_b": p[f"up{s}_b"], "conv1_w": p[f"c{s}1_w"],
               "gn1_g": p[f"gn{s}1_g"], "gn1_b": p[f"gn{s}1_b"], "conv2_w": p[f"c{s}2_w"],
               "gn2_g": p[f"gn{s}2_g"], "gn2_b": p[f"gn{s}2_b"]} for s in (1, 2))
    return d1, d2, {"w": p["hd_w"], "b": p["hd_b"]}


def _plain_vjp_target(x, hg1, hg2, *ps) -> torch.Tensor:
    """The function the plain backward differentiates: decoder_plain with the
    guidance planes given, computed in fp32, with values rounded through x's
    dtype where the kernels round (ConvT outputs and bias, pre-GN conv
    outputs, GN + ReLU outputs, weight matrices; the head stays fp32) as
    straight-through steps.  In fp32 it is decoder_plain's arithmetic; in
    bf16 its values are the bf16 kernels' and its cotangents stay fp32, where
    autograd through decoder_plain's bf16 convolutions would round each of
    them to bf16."""
    dt = x.dtype
    r = lambda t: t + (t.to(dt).float() - t).detach()  # noqa: E731
    p = {k: v.float() for k, v in zip(_DK, ps)}

    def stage(x, hg, s):
        u = conv_transpose2d_nonoverlap(x, r(p[f"up{s}_w"]), None, kernel=2)
        u = r(r(u) + r(p[f"up{s}_b"]))
        h = conv2d(u, r(p[f"c{s}1_w"]), None, padding=1)
        h = r((h.reshape(hg.shape[0], -1, *h.shape[1:]) + hg.float()[:, None]).reshape(h.shape))
        mid = h.shape[-1]
        h = r(torch.relu(group_norm(h, mid // 16, p[f"gn{s}1_g"], p[f"gn{s}1_b"])))
        h = r(conv2d(h, r(p[f"c{s}2_w"]), None, padding=1))
        return r(torch.relu(group_norm(h, mid // 16, p[f"gn{s}2_g"], p[f"gn{s}2_b"])))

    h = stage(stage(x.float(), hg1, 1), hg2, 2)
    return conv2d(h, r(p["hd_w"]), p["hd_b"], padding=1)[..., 0]


def decoder_backward_plain(x, hg1, hg2, dout, p: dict):
    """(dx, dhg1, dhg2, {key: grad}) by autograd through the plain version
    (:func:`_plain_vjp_target`)."""
    dx, dhg1, dhg2, *gs = plain_vjp(_plain_vjp_target, [x, hg1, hg2, *(p[k] for k in _DK)], dout)
    return dx, dhg1, dhg2, dict(zip(_DK, gs))


def decoder_backward(x, hg1, hg2, dout, p: dict):
    """(dx, dhg1, dhg2, {key: grad}) of the fused decoder over its Function's
    parameters (``_DK``): the CUDA kernel for CUDA tensors, the plain
    backward for CPU ones."""
    if x.is_cuda:
        return _decoder_bwd_cuda(x, hg1, hg2, dout, p)
    if x.device.type != "cpu":
        raise RuntimeError(f"no decoder backward path for device {x.device}")
    return decoder_backward_plain(x, hg1, hg2, dout, p)


class _DecoderFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, hg1, hg2, *params):
        ctx.save_for_backward(x, hg1, hg2, *params)
        if x.is_cuda:
            return _decoder_cuda(x, hg1, hg2, dict(zip(_DK, params)))
        if x.device.type == "cpu":
            return _decoder_planes(x, hg1, hg2, *_unpack(params))
        raise RuntimeError(f"no decoder path for device {x.device}")

    @staticmethod
    def backward(ctx, dout):
        x, hg1, hg2, *params = ctx.saved_tensors
        dx, dhg1, dhg2, g = decoder_backward(x, hg1, hg2, dout, dict(zip(_DK, params)))
        return (dx.to(x.dtype), dhg1.to(hg1.dtype), dhg2.to(hg2.dtype),
                *(g[k].to(pr.dtype) for k, pr in zip(_DK, params)))


def fused_decoder(x: torch.Tensor, g1: torch.Tensor, g2: torch.Tensor, d1: dict, d2: dict,
                  head: dict) -> torch.Tensor:
    """Both Up stages + head on x (B*T, 24, 24, 128) class slabs, image-major;
    g1 (B, 48, 48, Cg1), g2 (B, 96, 96, Cg2) -> (B*T, 96, 96) fp32 logits."""
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"no decoder path for device {x.device}")
    if x.is_cuda:
        _check_cuda(x, g1, g2, d1, d2)
    dt = x.dtype
    hg1 = _guidance_half(d1, g1, 96, dt)
    hg2 = _guidance_half(d2, g2, 48, dt)
    return _DecoderFn.apply(x, hg1, hg2, *_params(d1, d2, head))
