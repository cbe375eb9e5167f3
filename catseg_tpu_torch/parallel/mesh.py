"""The data axis, the process group and the launcher (catseg_tpu/parallel/mesh.py).

catseg_tpu is one program over one ``Mesh`` whose "data" axis carries
training batches, evaluation images and a single image's sliding-window
tiles.  The port takes PyTorch's idiom for each use:

- Training and benchmark evaluation run one process per GPU in a
  ``torch.distributed`` process group (the reference's DDP, train_net.py:
  317-324): every rank runs the unchanged single-GPU program on its slice of
  the batch, and one ``all_reduce`` sums what the ranks share (gradients and
  the loss, a confusion matrix).  The backend is named by the caller: NCCL
  for one GPU a rank, gloo for CPU ranks or for ranks that share one card.
  The collectives are ``all_reduce`` and ``broadcast`` only, the two that
  gloo carries for CUDA tensors, so the same code runs over either backend.
- Single-image latency (``parallel/latency.py``) runs one process over a
  list of devices, one model replica each.

:class:`Mesh` describes either: ``devices`` are the replicas this process
drives, ``ranks`` the processes along the axis (each driving one device).

Not ported: the class axis (``n_class > 1``: catseg_tpu's GSPMD sharding of
T through the aggregator, ``constrain_class_axis`` / ``shard_kernel`` /
``pallas_allowed`` / ``mesh_divides``, and ``use_mesh`` / ``local_region``,
which only mark GSPMD regions).  It is ROADMAP A6b, and asking for it
raises.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

A6B = ("class-axis model parallelism is not ported (ROADMAP A6b: catseg_tpu shards the class axis T "
       "through the aggregator with GSPMD)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data axis: ``devices`` hold one model replica each in this process;
    ``ranks`` is the number of processes along the axis (1 outside a process
    group), each with one device."""

    devices: tuple[torch.device, ...]
    ranks: int = 1

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices) * self.ranks, "class": 1}

    @property
    def size(self) -> int:
        return self.shape["data"]


def rank() -> int:
    """This process's rank in the default group (0 outside one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """Processes in the default group (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


_rank, _world_size = rank, world_size   # for the functions whose arguments take these names


def make_mesh(n_data: int | None = None, n_class: int = 1, devices=None) -> Mesh:
    """The data axis over ``devices`` (default: every visible GPU), the
    first ``n_data`` of them.  Inside a process group the axis is the
    group's ranks, one device each (``devices``, if given, names this rank's
    one device; default the current GPU).  ``n_class > 1`` raises
    NotImplementedError (ROADMAP A6b)."""
    if n_class != 1:
        raise NotImplementedError(f"make_mesh(n_class={n_class}): {A6B}")
    if dist.is_initialized():
        if devices is None:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        if len(devices) != 1 or n_data not in (None, world_size()):
            raise ValueError(f"inside a process group of {world_size()} ranks each rank holds one device; got "
                             f"devices={devices}, n_data={n_data}")
        return Mesh(devices=(torch.device(devices[0]),), ranks=world_size())
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device visible; pass devices= (e.g. ['cpu'] * 3) to build a "
                               "mesh of CPU replicas")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n_data = len(devices) if n_data is None else n_data
    if not 1 <= n_data <= len(devices):
        raise ValueError(f"make_mesh: n_data={n_data} with {len(devices)} devices")
    return Mesh(devices=tuple(devices[:n_data]))


def init_process_group(backend: str, rank: int, world_size: int, store_path: str) -> None:
    """Join the default group over a ``FileStore`` at ``store_path``.
    ``backend`` is "nccl" (one GPU a rank) or "gloo" (CPU ranks, or ranks
    sharing one card); an NCCL failure raises, nothing falls back to gloo."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' needs a CUDA device")
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _worker(rank: int, fn, args, world_size: int, backend: str, devices, tmp: str) -> None:
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_process_group(backend, rank, world_size, os.path.join(tmp, "store"))
    try:
        result = fn(*args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        destroy_process_group()


def spawn(fn, world_size: int, *args, backend: str, devices=None, tmp_dir: str | None = None) -> list:
    """Run ``fn(*args)`` in ``world_size`` new processes (the spawn start
    method), rank r on ``devices[r]`` (default: GPU r) in one process group;
    returns each rank's return value (pickled through a file).  ``fn`` must
    be importable by name; it reads its rank with :func:`rank`.  A failing
    rank ends the others and raises here.  The FileStore and the results
    live in a fresh directory under ``tmp_dir`` (default: the system's
    temporary directory), removed afterwards."""
    import torch.multiprocessing as mp

    if devices is None:
        if torch.cuda.device_count() < world_size:
            raise RuntimeError(f"spawn: {world_size} ranks but {torch.cuda.device_count()} GPUs visible")
        devices = [f"cuda:{r}" for r in range(world_size)]
    devices = [str(d) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"spawn: {world_size} ranks but {len(devices)} devices")
    with tempfile.TemporaryDirectory(dir=tmp_dir) as tmp:
        mp.start_processes(_worker, args=(fn, args, world_size, backend, devices, tmp), nprocs=world_size,
                           join=True, start_method="spawn")
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def shard_batch(batch, rank: int | None = None, world_size: int | None = None):
    """This rank's contiguous slice of a global batch (an array or tensor,
    or a tuple / list of them, split on axis 0).  A batch that does not
    divide by the world size raises (ROADMAP A6b: catseg_tpu falls back to
    its GSPMD class-axis path there)."""
    r = _rank() if rank is None else rank
    n = _world_size() if world_size is None else world_size
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, r, n) for b in batch)
    B = batch.shape[0]
    if B % n:
        raise NotImplementedError(f"a batch of {B} does not divide over {n} ranks: {A6B}")
    return batch[r * (B // n):(r + 1) * (B // n)]


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place
    (DistributedDataParallel's start-up broadcast); a no-op outside a group."""
    if world_size() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module
