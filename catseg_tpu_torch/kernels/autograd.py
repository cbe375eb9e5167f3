"""The plain backward shared by the kernels' ``torch.autograd.Function``s."""

from __future__ import annotations

import torch


def plain_vjp(fn, inputs, grad_out):
    """Gradients of fn(*inputs) against grad_out by autograd through fn, one
    per input (None for a None or non-float input, or one fn does not use)."""
    with torch.enable_grad():
        inp = [t.detach().requires_grad_() if isinstance(t, torch.Tensor) and t.is_floating_point() else t
               for t in inputs]
        out = fn(*inp)
        want = [t for t in inp if isinstance(t, torch.Tensor) and t.requires_grad]
        got = iter(torch.autograd.grad(out, want, grad_out, allow_unused=True))
    return [next(got) if isinstance(t, torch.Tensor) and t.requires_grad else None for t in inp]
