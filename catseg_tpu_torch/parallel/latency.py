"""Single-image latency parallelism: split the sliding-window tile batch
over devices (catseg_tpu/parallel/latency.py).

The reference's only parallelism is DDP over *images* (plain_train_net.py:
241-260): one image's latency never improves with more GPUs.  The
sliding-window forward of ONE image is itself a batch of ``nt + 1`` tiles (4
window tiles and the global view at the eval preset, cat_seg_model.py:
156-176), so splitting that tile axis over devices turns spare GPUs into
latency.  This has no reference equivalent (DDP cannot split one image); it
serves the demo / video path, where per-frame latency, not throughput, is
the product metric.

One process drives every device: one model replica a device (the caller's
model on the first, copies on the others, made at the first call), the
tiles split contiguously with one host thread a device (a device may get one
tile fewer; there are no static shapes to pad to), each replica running the
unchanged single-GPU forward with its kernels (the ctypes launches release
the interpreter lock), then the (tiles, T, h, w) logits gathered on the first
device, where the fold tail runs.  The replicas are copies of the model as
it was at their first call: a model trained afterwards needs a new function.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor

import torch

from ..configs import CATSegConfig
from ..infer.pipeline import canvas_to_sliding_inputs, sliding_tail, sliding_tiles
from .mesh import Mesh


def make_tile_sharded_forward(mesh: Mesh):
    """Returns ``forward(model, tiles, text_feats, cfg)``: the model's logits
    for a tile batch, computed on ``mesh.devices`` (each device its
    contiguous share of the tiles) and gathered, in order, on the first.
    ``model`` must be on the first device."""
    if mesh.ranks != 1:
        raise ValueError("tile sharding runs in one process over a list of devices; this mesh spans "
                         f"{mesh.ranks} processes")
    devices = mesh.devices
    replicas: dict = {}

    def replica(model, text_feats, i: int):
        key = (id(model), i)
        if key not in replicas:
            m = model if i == 0 else copy.deepcopy(model).to(devices[i])
            replicas[key] = (model, m)          # the first entry keeps the id's object alive
        return replicas[key][1], text_feats.to(devices[i])

    def forward(model, tiles: torch.Tensor, text_feats: torch.Tensor, cfg: CATSegConfig) -> torch.Tensor:
        chunks = [c for c in torch.tensor_split(tiles, len(devices)) if len(c)]
        inference, grad = torch.is_inference_mode_enabled(), torch.is_grad_enabled()

        def run(i: int) -> torch.Tensor:
            # the caller's autograd mode: it is thread-local
            with torch.inference_mode(inference), torch.set_grad_enabled(grad):
                m, text = replica(model, text_feats, i)
                return m(chunks[i].to(devices[i]), text, cfg).to(devices[0])

        with ThreadPoolExecutor(len(chunks)) as pool:
            futures = [pool.submit(run, i) for i in range(len(chunks))]
            return torch.cat([f.result() for f in futures])

    return forward


def make_tile_sharded_probs(cfg: CATSegConfig, mesh: Mesh):
    """Returns ``fn(model, canvas, hw, text_feats) -> (out, out, T)``
    probabilities with the contract of
    ``infer.pipeline.sliding_window_probs_from_canvas`` (canvas: (Hc, Wc, 3)
    zero-padded raw RGB, hw: (2,) int true size), the tile batch's forward
    split over ``mesh.devices``; the result is on the first device."""
    forward = make_tile_sharded_forward(mesh)
    dev0 = mesh.devices[0]

    def fn(model, canvas, hw, text_feats) -> torch.Tensor:
        img_out, img_k = canvas_to_sliding_inputs(torch.as_tensor(canvas, device=dev0),
                                                  torch.as_tensor(hw, device=dev0), cfg)
        logits = forward(model, sliding_tiles(img_out[None], img_k[None], cfg), text_feats, cfg)
        return sliding_tail(logits, 1, cfg)[0].permute(1, 2, 0)

    return fn
