"""The data and class axes, the process group and the launcher
(catseg_tpu/parallel/mesh.py).

catseg_tpu is one program over one ``Mesh`` whose "data" axis carries
training batches, evaluation images and a single image's sliding-window
tiles, and whose "class" axis shards the class axis T through the
aggregator.  The port takes PyTorch's idiom for each use:

- Training and benchmark evaluation run one process per GPU in a
  ``torch.distributed`` process group (the reference's DDP, train_net.py:
  317-324): every rank runs the unchanged single-GPU program on its slice of
  the batch, and one ``all_reduce`` sums what the ranks share (gradients and
  the loss, a confusion matrix).  The backend is named by the caller: NCCL
  for one GPU a rank, gloo for CPU ranks or for ranks that share one card.
  The collectives are ``all_reduce`` and ``broadcast`` only, the two that
  gloo carries for CUDA tensors, so the same code runs over either backend.
- The class axis is a set of ranks of that group: ``make_mesh(n_data=,
  n_class=)`` lays the ranks out row-major, as catseg_tpu's
  ``reshape(n_data, n_class)``, and gives each rank two subgroups, its data
  row's ranks (the class group, which shares its images) and its class
  column's (the data group).  ``parallel/class_axis.py`` holds the class
  axis's collectives, which the aggregator and the train step call with the
  mesh passed explicitly; there is no global mesh.
- Single-image latency (``parallel/latency.py``) runs one process over a
  list of devices, one model replica each.

:class:`Mesh` describes any of these: ``devices`` are the replicas this
process drives, ``ranks`` the processes of the group (each driving one
device), ``n_class`` of them along the class axis.

Not ported: ``use_mesh``, ``local_region``, ``pallas_allowed``,
``mesh_divides`` and ``shard_kernel``, which only mark or guard GSPMD
regions; the port shards by explicit collectives, not by GSPMD.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

INDIVISIBLE = "catseg_tpu's jitted step refuses such a batch too (pjit: arguments must divide over the data axis)"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` hold one model replica each in this process; ``ranks``
    is the number of processes of the group (1 outside one), each with one
    device, laid out as (data, class) = divmod(rank, n_class).  A class
    axis carries ``class_group`` (this rank's data row) and ``data_group``
    (its class column)."""

    devices: tuple[torch.device, ...]
    ranks: int = 1
    n_class: int = 1
    class_group: object = None
    data_group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices) * self.ranks // self.n_class, "class": self.n_class}

    @property
    def size(self) -> int:
        return len(self.devices) * self.ranks

    @property
    def data_index(self) -> int:
        """This rank's position along the data axis: the image slice it takes."""
        return rank() // self.n_class

    @property
    def class_index(self) -> int:
        """This rank's position along the class axis: the class slab it takes."""
        return rank() % self.n_class


def rank() -> int:
    """This process's rank in the default group (0 outside one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """Processes in the default group (1 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


_rank, _world_size = rank, world_size   # for the functions whose arguments take these names


def make_mesh(n_data: int | None = None, n_class: int = 1, devices=None) -> Mesh:
    """The data axis over ``devices`` (default: every visible GPU), the
    first ``n_data`` of them.  Inside a process group the axes are the
    group's ranks, one device each (``devices``, if given, names this rank's
    one device; default the current GPU): ``n_data x n_class`` must be the
    world size (``n_data`` defaults to world / n_class).  Every rank must
    call it, in the same order as the others, since a class axis creates
    its subgroups on every rank.  A class axis outside a process group
    raises: it needs ranks, as training does."""
    if n_class < 1:
        raise ValueError(f"make_mesh: n_class={n_class}")
    if dist.is_initialized():
        n = world_size()
        if devices is None:
            devices = [torch.device("cuda", torch.cuda.current_device())]
        if len(devices) != 1:
            raise ValueError(f"inside a process group of {n} ranks each rank holds one device; got "
                             f"devices={devices}")
        if n_data is None and n % n_class == 0:
            n_data = n // n_class
        if n_data is None or n_data * n_class != n:
            raise ValueError(f"make_mesh(n_data={n_data}, n_class={n_class}) does not fill the group's {n} ranks")
        if n_class == 1:
            return Mesh(devices=(torch.device(devices[0]),), ranks=n)
        # every rank creates every subgroup, in one order: rows, then columns
        rows = [dist.new_group(list(range(d * n_class, (d + 1) * n_class))) for d in range(n_data)]
        columns = [dist.new_group(list(range(c, n, n_class))) for c in range(n_class)]
        data_index, class_index = divmod(rank(), n_class)
        return Mesh(devices=(torch.device(devices[0]),), ranks=n, n_class=n_class,
                    class_group=rows[data_index], data_group=columns[class_index])
    if n_class != 1:
        raise ValueError(f"make_mesh(n_class={n_class}) outside a process group: the class axis is a set of ranks "
                         "(parallel.mesh.spawn or init_process_group first), one device each")
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
    or a tuple / list of them, split on axis 0), by default over every rank
    of the group; on a class axis pass ``mesh.data_index`` and
    ``mesh.shape["data"]``, since a data row's class ranks share its images.
    A batch that does not divide over the ranks raises, as catseg_tpu's
    jitted step does."""
    r = _rank() if rank is None else rank
    n = _world_size() if world_size is None else world_size
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, r, n) for b in batch)
    B = batch.shape[0]
    if B % n:
        raise NotImplementedError(f"a batch of {B} does not divide over {n} ranks: {INDIVISIBLE}")
    return batch[r * (B // n):(r + 1) * (B // n)]


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place
    (DistributedDataParallel's start-up broadcast); a no-op outside a group."""
    if world_size() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module
