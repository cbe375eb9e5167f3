"""Transformer MLP act(x W1 + b1) W2 + b2: CUDA kernel + plain PyTorch version.

Replaces catseg_tpu/kernels/mlp.py:fused_mlp (Pallas _kernel).  The kernel
(csrc/mlp.cu) walks the hidden width in chunks per row tile, so the 4x
hidden never reaches device memory.  In bf16 it runs both products on
mma.sync tensor cores, the weight chunks streaming through a cp.async ring:
up to 256 channels in and out, 256 rows a CTA, each hidden chunk going from
the first product's accumulators to the second's A fragments in registers;
past 256 (the aggregator's MLPs at hidden 384 and 512), 64 rows a CTA, the
output columns split over the warps and each hidden chunk shared through
shared memory.  Its note there says what bounds it on the card.  Weights
use the reference's (in, out) layout, read as they are (no packing).  GELU
takes the tanh form in bf16 and erf in fp32 (the reference's dtype
predicate); the hidden is rounded to x's dtype before the second product.

The kernel takes C a multiple of 16 up to 512, H a multiple of 128 and 32,
64, 128, 256, 384 or 512 outputs, any row count (:func:`kernel_takes`), so
every C -> 4C -> C MLP the reference runs on its kernel (C 128, 256, 384,
512) runs on the port's.  A call is
routed by geometry alone, before any launch (:func:`route`): on a CUDA
tensor the kernel runs where it takes the geometry; elsewhere the plain
version runs where the reference's own Pallas gate fails
(:func:`reference_gate`: C and H multiples of 128, at least one 1024-row
tile, C * H <= 2^20), as the reference runs its ``_reference`` there, and
the call raises where that gate holds (a geometry the reference runs on its
kernel and the port's does not take).  A CPU tensor always takes the plain
version.  The kernel also raises for x, w1 or w2 not 16-byte aligned.

Gradients: the kernel call sits in a ``torch.autograd.Function`` whose
backward is autograd through the plain version on every device, as the
reference's ``_bwd`` is ``jax.vjp`` of its ``_reference``.
"""

from __future__ import annotations

import torch

from . import _build
from .autograd import plain_vjp
from .ops import records_grad, register, serve
from .swin_block import gelu

_ACT = {"gelu": 0, "relu": 1}


def mlp_plain(x: torch.Tensor, w1, b1, w2, b2, act: str) -> torch.Tensor:
    """act(x @ w1 + b1) @ w2 + b2 over the last axis, fp32 products of
    dtype-rounded operands, the hidden rounded to x's dtype."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float() + b1.float()
    h = (gelu(h, dt == torch.bfloat16) if act == "gelu" else torch.relu(h)).to(dt)
    return (h.float() @ w2.to(dt).float() + b2.float()).to(dt)


OUT_WIDTHS = (32, 64, 128, 256, 384, 512)


def kernel_takes(C: int, H: int, Co: int) -> bool:
    """The geometry the CUDA kernel takes: C a multiple of 16 up to 512 in, a
    hidden width H a multiple of 128, Co in ``OUT_WIDTHS`` outputs."""
    return C % 16 == 0 and 0 < C <= 512 and H % 128 == 0 and Co in OUT_WIDTHS


def reference_gate(C: int, H: int, M: int) -> bool:
    """Where the reference runs its Pallas kernel (catseg_tpu/kernels/mlp.py
    ``fused_mlp``): C and H multiples of 128, at least one 1024-row tile of
    M rows, C * H <= 2^20 (the weights beside the tiles in VMEM)."""
    return C % 128 == 0 and H % 128 == 0 and M >= 1024 and C * H <= 1 << 20


def route(C: int, H: int, Co: int, M: int) -> str:
    """What a CUDA call at this geometry runs: "kernel" where the kernel
    takes it, else "plain" where the reference runs its plain composition,
    else "raise" (the reference's kernel takes it, the port's does not)."""
    if kernel_takes(C, H, Co):
        return "kernel"
    return "raise" if reference_gate(C, H, M) else "plain"


def _mlp_cuda(x, w1, b1, w2, b2, act: str) -> torch.Tensor:
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"mlp kernel takes fp32 or bf16, got {dt}")
    C, H = w1.shape
    Co = w2.shape[1]
    if w2.shape[0] != H or x.shape[-1] != C:
        raise ValueError(f"mlp shapes do not chain: x (..., {x.shape[-1]}), w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    way = route(C, H, Co, x.numel() // C)
    if way == "plain":
        return mlp_plain(x, w1, b1, w2, b2, act)
    if way == "raise":
        raise NotImplementedError(f"mlp kernel takes C a multiple of 16 up to 512, H a multiple of 128 and "
                                  f"{', '.join(map(str, OUT_WIDTHS))} outputs; got {C}->{H}->{Co}, where the "
                                  "reference's kernel runs")
    x2 = x.reshape(-1, C).contiguous()
    w1, w2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    # the bf16 kernel lands x rows and weight chunks by 16-byte cp.async
    if any(t.data_ptr() % 16 for t in (x2, w1, w2)):
        raise ValueError("mlp kernel reads x, w1 and w2 in 16-byte vectors: each must start 16-byte aligned; got "
                         f"addresses mod 16 {[t.data_ptr() % 16 for t in (x2, w1, w2)]}")
    out = torch.empty((x2.shape[0], Co), dtype=dt, device=x.device)
    _build.launch("catseg_mlp", x2, w1, b1.float().contiguous(), w2, b2.float().contiguous(), out, x2.shape[0], C, H,
                  Co, _ACT[act], int(dt == torch.bfloat16))
    _build.count("mlp")
    return out.view(*x.shape[:-1], Co)


class _MLPFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, act):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.act = act
        if x.is_cuda:
            return _mlp_cuda(x, w1, b1, w2, b2, act)
        if x.device.type == "cpu":
            return mlp_plain(x, w1, b1, w2, b2, act)
        raise RuntimeError(f"no mlp path for device {x.device}")

    @staticmethod
    def backward(ctx, g):
        act = ctx.act
        return (*plain_vjp(lambda *a: mlp_plain(*a, act), ctx.saved_tensors, g), None)


mlp_op = register(
    "mlp", "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, str act) -> Tensor", mlp_plain, _mlp_cuda,
    lambda x, w1, b1, w2, b2, act: x.new_empty((*x.shape[:-1], w2.shape[1])))


def fused_mlp(x: torch.Tensor, w1, b1, w2, b2, act: str = "gelu") -> torch.Tensor:
    """act(x @ w1 + b1) @ w2 + b2 over the last axis, any leading shape;
    ``act`` is "gelu" or "relu".  Where no gradient is recorded, the op
    ``catseg_tpu_torch::mlp`` (``kernels/ops.py``)."""
    if act not in _ACT:
        raise ValueError(f"act must be 'gelu' or 'relu', got {act!r}")
    if records_grad(x, w1, b1, w2, b2):
        return _MLPFn.apply(x, w1, b1, w2, b2, act)
    return serve(mlp_op, "mlp", x, w1, b1, w2, b2, act)
