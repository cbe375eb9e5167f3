"""Ahead-of-time export of the serving pipeline (catseg_tpu/infer/export.py)
as a ``torch.export`` artifact.

The reference serializes its whole serving graph to StableHLO with the
weights embedded.  Here the same graph, canvas upload -> in-graph resizes
from the runtime size -> sliding window -> fold / average -> resize-argmax
to the runtime output size, is traced by ``torch.export`` and written with
``torch.export.save`` (a ``.pt2``), weights and text features as its state.
The forward kernels are ``torch.library`` ops (``kernels/ops.py``), so the
traced graph calls the hand-written kernels, and a loaded artifact launches
them when it runs.

Limits the reference's StableHLO does not have: the artifact loads only
where ``catseg_tpu_torch`` is importable (its nodes are this package's
ops; :func:`load_exported` registers them first), and it is bound to the
device it was traced on (the card, or the CPU's plain versions).  Shapes
are static by design, one artifact per (input canvas, output canvas, T),
as the reference's.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
import torch.nn as nn

from ..configs import CATSegConfig
from ..core.catseg import CATSeg
from ..kernels.ops import load_ops
from .pipeline import resize_argmax_dynamic, sliding_window_probs_from_canvas


@dataclasses.dataclass(frozen=True)
class ExportSpec:
    """Static geometry of one exported serving function."""

    input_canvas: tuple[int, int]  # (Hc, Wc) padded uint8 input
    out_canvas: tuple[int, int]  # (Ho, Wo) padded argmax output
    num_classes: int


def _without_text_tower(model: CATSeg) -> CATSeg:
    """The model sharing every parameter but the CLIP text tower's, which
    serving does not run (the text features are the module's state): the
    modules on the path to the CLIP are shallow copies, the caller's model
    is not touched."""
    def shallow(m, **children):
        c = copy.copy(m)
        c._modules = {**m._modules, **children}
        return c

    clip = shallow(model.clip)
    clip._modules = {"visual": model.clip.visual}
    clip._parameters = {}
    predictor = shallow(model.sem_seg_head.predictor, clip_model=clip)
    return shallow(model, sem_seg_head=shallow(model.sem_seg_head, predictor=predictor))


class ServeModule(nn.Module):
    """(canvas uint8 (Hc, Wc, 3), hw int32 (2,), out_hw int32 (2,)) -> (Ho, Wo)
    int32 argmax map: the sliding-window pipeline from a zero-padded canvas,
    the true input size ``hw`` and output size ``out_hw`` taken at run time."""

    def __init__(self, model: CATSeg, cfg: CATSegConfig, text_feats, spec: ExportSpec):
        super().__init__()
        self.model = _without_text_tower(model) if type(model) is CATSeg else model
        self.cfg = cfg
        self.spec = spec
        device = next(model.parameters()).device
        self.register_buffer("text_feats", torch.as_tensor(text_feats, dtype=torch.float32, device=device))

    def forward(self, canvas: torch.Tensor, hw: torch.Tensor, out_hw: torch.Tensor) -> torch.Tensor:
        probs = sliding_window_probs_from_canvas(self.model, canvas, hw, self.text_feats, self.cfg)
        return resize_argmax_dynamic(probs, out_hw, self.spec.out_canvas)


def make_serve_fn(model: CATSeg, cfg: CATSegConfig, text_feats, spec: ExportSpec) -> ServeModule:
    """The serving function as an eval-mode :class:`ServeModule` on the
    model's device (call it under ``torch.inference_mode()`` to run it live)."""
    return ServeModule(model, cfg, text_feats, spec).eval()


def _example_inputs(spec: ExportSpec, device) -> tuple[torch.Tensor, ...]:
    Hc, Wc = spec.input_canvas
    return (torch.zeros((Hc, Wc, 3), dtype=torch.uint8, device=device),
            torch.tensor([Hc, Wc], dtype=torch.int32, device=device),
            torch.tensor(list(spec.out_canvas), dtype=torch.int32, device=device))


def export_serving(model: CATSeg, cfg: CATSegConfig, text_feats, spec: ExportSpec, path: str):
    """Trace the serving function for ``spec`` on the model's device with
    ``torch.export.export`` (no gradient recorded, so every kernel wrapper
    takes its op) and write it to ``path``; returns the ExportedProgram."""
    serve = make_serve_fn(model, cfg, text_feats, spec)
    device = next(model.parameters()).device
    with torch.no_grad():
        exported = torch.export.export(serve, _example_inputs(spec, device))
    torch.export.save(exported, path)
    return exported


def load_exported(path: str):
    """Register the port's kernel ops, load an artifact and return a callable
    (canvas, hw, out_hw) -> (Ho, Wo) int32 tensor on the artifact's device;
    numpy inputs are moved there."""
    load_ops()
    exported = torch.export.load(path)
    module = exported.module()
    device = next(iter(exported.state_dict.values())).device

    def call(canvas, hw, out_hw):
        args = [torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray) else a, device=device)
                for a in (canvas, hw, out_hw)]
        with torch.inference_mode():
            return module(args[0], args[1].to(torch.int32), args[2].to(torch.int32))

    call.exported = exported
    return call
