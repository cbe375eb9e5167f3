"""Parallelism over GPUs: the process group, its launcher and the data and
class axes (``mesh``), the class axis's collectives (``class_axis``), and
tile-sharded single-image latency (``latency``, which imports the inference
stack and so is not imported here)."""

from .mesh import Mesh, make_mesh, rank, replicate, shard_batch, spawn, world_size

__all__ = ["Mesh", "make_mesh", "rank", "replicate", "shard_batch", "spawn", "world_size"]
