"""The forward kernels as ``torch.library`` custom ops.

Each forward kernel (#1-#4, #6, #8, #10-#12) is registered as
``catseg_tpu_torch::<name>`` by its wrapper module: the CUDA implementation
is the wrapper's launch code (every ``data_ptr()`` read, alignment check and
launch count inside it), the CPU implementation its plain version, and a
fake implementation gives the output's shape and dtype.  So ``torch.export``
traces the serving graph through the hand-written kernels (its nodes are
these ops), and an exported program runs them when it is called.

The public wrappers call their op where autograd records nothing (serving,
export); where it records, they keep their ``torch.autograd.Function``s
(training).  The backward kernels are not ops: export is a serving path.
Dict-valued parameters (the Swin block's, the class layer's, the
decoder's) go in as one tensor list in the wrapper's fixed key order.
"""

from __future__ import annotations

import importlib

import torch

NAMESPACE = "catseg_tpu_torch"

# op name -> the wrapper module that registers it
OPS = {
    "layer_norm": "layer_norm", "dense_attention": "clip_attn", "corr_embed": "corr_embed",
    "swin_block": "swin_block", "class_layer": "class_layer", "decoder": "decoder",
    "window_attention": "window_attn", "mlp": "mlp", "linear_attention": "linear_attn",
}


def register(name: str, schema: str, cpu, cuda, fake):
    """``catseg_tpu_torch::name`` with ``schema``: ``cpu`` on CPU tensors,
    ``cuda`` on CUDA tensors, ``fake`` for tracing; returns the op."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu, mutates_args=(), device_types="cpu", schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op


def serve(op, what: str, *args):
    """``op(*args)`` on a CPU or CUDA first argument; any other device raises
    (no plain fallback: the fake implementation would give a shape only)."""
    if not args[0].is_cuda and args[0].device.type != "cpu":
        raise RuntimeError(f"no {what} path for device {args[0].device}")
    return op(*args)


def records_grad(*tensors) -> bool:
    """Whether autograd would record a call on these tensors (None skipped)."""
    return torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def load_ops() -> None:
    """Register every op (import each wrapper module); builds nothing."""
    for module in set(OPS.values()):
        importlib.import_module(f"{__package__}.{module}")
