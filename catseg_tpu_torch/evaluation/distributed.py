"""Rank-sharded benchmark evaluation (catseg_tpu/evaluation/distributed.py).

The reference shards evaluation images over DDP ranks and all_gathers the
confusion matrices (plain_train_net.py:136-146).  Here each rank of the
process group (``parallel.mesh``) runs the unchanged single-GPU batched
sliding path, ``Predictor.preds_sliding_batch`` and an int64
``ConfusionAccumulator`` on its device, over its share of the images, and
one ``all_reduce`` of the (K+1)² matrix sums the shares: every rank returns
the same matrix.

The shares are catseg_tpu's: the images go in dispatch rounds of
``ranks * per_device_batch``, and rank r takes the r-th run of
``per_device_batch`` of each round (its ``P("data")`` split of the batch
axis), so a short last round leaves later ranks fewer images or none.

Not ported: catseg_tpu's ``SPILL_PIXELS``, which moves its int32 device
matrix to a host int64 before a cell could overflow (TPU int32 with x64
off); the port's matrix is int64 on the device from the start.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..configs import CATSegConfig
from ..infer.pipeline import Predictor
from ..parallel.mesh import Mesh, rank, world_size
from .miou import ConfusionAccumulator


def owner(index: int, ranks: int, per_device_batch: int) -> int:
    """The rank that evaluates item ``index``."""
    return (index // per_device_batch) % ranks


def make_sharded_eval_step(model, cfg: CATSegConfig, text_feats, out_canvas, num_classes: int, ignore: int,
                           clamp_background: bool = False):
    """Returns (step, acc): ``step(items)`` adds this rank's batch of
    (image (h, w, 3) uint8, gt (H, W) int) pairs into ``acc``, a
    ConfusionAccumulator on the model's device, through one
    ``preds_sliding_batch`` (each image at its own size, its argmax at its
    GT's size on the ``out_canvas`` frame, the GT padded with ``ignore``)."""
    device = next(model.parameters()).device
    text = torch.as_tensor(text_feats)
    predictor = Predictor(model, cfg, [str(i) for i in range(text.shape[0])], text_feats=text, device=device)
    acc = ConfusionAccumulator(num_classes, ignore, clamp_background=clamp_background, device=device)
    Hc, Wc = out_canvas

    def step(items) -> None:
        hws = np.array([gt.shape for _, gt in items], np.int32)
        preds = predictor.preds_sliding_batch([im for im, _ in items], hws, (Hc, Wc))
        gts = torch.full((len(items), Hc, Wc), ignore, dtype=torch.int32, device=device)
        for i, (_, gt) in enumerate(items):
            H, W = gt.shape
            gts[i, :H, :W] = torch.from_numpy(np.asarray(gt, np.int32)).to(device)
        acc.update(preds, gts)

    return step, acc


def evaluate_sharded(model, cfg: CATSegConfig, mesh: Mesh, items, text_feats, *, out_canvas, num_classes: int,
                     ignore: int, clamp_background: bool = False, per_device_batch: int = 2) -> np.ndarray:
    """items: an iterable of (image (h, w, 3) uint8, gt (H, W) int) over
    every rank's images, each rank iterating the same sequence; an item
    another rank owns is skipped unread (it may be None).  Returns the
    confusion matrix summed over the ranks (numpy int64), the same on every
    rank.  ``mesh`` is the group's (``make_mesh()`` inside it, or a mesh of
    one device outside one); on a mesh with a class axis the images go over
    all ``n_data * n_class`` ranks, as catseg_tpu's step treats both axes
    as image axes.  Unlike catseg_tpu's it takes no ``input_canvas``: each
    image runs at its own size."""
    if len(mesh.devices) != 1 or mesh.ranks != world_size():
        raise ValueError(f"evaluate_sharded shards over every rank of a process group, one device each; this mesh "
                         f"holds {len(mesh.devices)} devices in each of {mesh.ranks} processes, the group "
                         f"{world_size()}")
    pdb = max(1, per_device_batch)
    step, acc = make_sharded_eval_step(model, cfg, text_feats, out_canvas, num_classes, ignore, clamp_background)
    me, n = rank(), mesh.ranks
    buf: list = []
    for i, item in enumerate(items):
        if owner(i, n, pdb) != me:
            continue
        buf.append(item)
        if len(buf) == pdb:
            step(buf)
            buf = []
    if buf:
        step(buf)
    if dist.is_initialized():
        dist.all_reduce(acc.cm)
    return acc.matrix()
