"""The class axis's collectives (catseg_tpu/parallel/mesh.py
``constrain_class_axis``; the gather in front of its fused class layer,
catseg_tpu/core/aggregator.py:332-338).

A rank of a class mesh (``parallel.mesh.make_mesh(n_data=, n_class=)``)
aggregates the contiguous slab ``[t0, t1)`` of the class axis that
:func:`class_slab` gives it; the ranks of one data row (the mesh's class
group) hold the slabs of the same images.  The class layer attends over
all classes, so its input is gathered over the class group
(:func:`gather_classes_axis`) and each rank keeps its slab of the output.

The gather is an ``all_reduce`` (sum) of the local slab written into zeros,
because gloo carries only ``all_reduce`` and ``broadcast`` for CUDA tensors
and the same code must run over NCCL and over gloo ranks sharing a card.
Adding zeros is exact, so the gather is bit-exact.  The tensor travels in
its own dtype: gloo sums bf16 on the builds the port runs on (torch 2.11 on
the card, 2.13 on the CPU), so bf16 needs no fp32 carrier.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist


def class_slab(T: int, axis) -> tuple[int, int]:
    """This rank's classes ``[t0, t1)`` of ``T`` on the mesh ``axis`` (None,
    or a mesh without a class axis: all of them).  A T that does not divide
    over the class axis warns, as catseg_tpu's ``constrain_class_axis``
    does, and gives every rank all T: the class ranks then compute the same
    thing."""
    n = 1 if axis is None else axis.n_class
    if n == 1:
        return 0, T
    if T % n:
        warnings.warn(f"class axis T={T} not divisible by mesh class axis {n}; every class rank aggregates all "
                      "T classes (class-axis ranks compute the same thing)", UserWarning, stacklevel=2)
        return 0, T
    k = T // n
    c = axis.class_index
    return c * k, (c + 1) * k


def _gather(x: torch.Tensor, axis) -> torch.Tensor:
    k = x.shape[1]
    full = x.new_zeros((x.shape[0], k * axis.n_class, *x.shape[2:]))
    c = axis.class_index
    full[:, c * k:(c + 1) * k] = x
    dist.all_reduce(full, group=axis.class_group)
    return full


class _GatherClasses(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.k = axis, x.shape[1]
        return _gather(x, axis)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.axis.class_group)
        c, k = ctx.axis.class_index, ctx.k
        return grad[:, c * k:(c + 1) * k].contiguous(), None


def gather_classes_axis(x: torch.Tensor, axis) -> torch.Tensor:
    """(B, T / n_class, ...) class slabs -> (B, T, ...) over the class group
    of ``axis``; each rank's slab lands at its ``class_slab``.  Backward:
    the incoming gradients summed over the class group, this rank's slab
    of the sum (every rank's loss reaches every slab through the gather)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherClasses.apply(x, axis)
    return _gather(x, axis)
