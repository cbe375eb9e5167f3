"""Host-side data loading: decode, test-time resize, dataset listing, prefetch
(catseg_tpu/data/loader.py).

Replaces detectron2's load_sem_seg + ResizeShortestEdge test mapper.  Decoding
is ``data.image_io`` and the uint8 resize ``data.resize``: the same bytes as
the JAX package's imaging-library path, without that library.  A background
prefetcher overlaps decode with the card (the reference used 8 dataloader
worker processes for the same job); the C++ decoder releases the GIL.
"""

from __future__ import annotations

import json
import os
import queue
import threading

import numpy as np

from .catalogs import DatasetSpec, dataset_root
from .image_io import decode_array, decode_rgb, probe_size
from .resize import resize_bilinear_u8, resize_nearest


def list_dataset(spec: DatasetSpec, root: str | None = None, limit: int | None = None):
    """[(image_path, gt_path)]: pairs matched by basename, sorted
    (load_sem_seg semantics)."""
    root = root or dataset_root()
    img_dir = os.path.join(root, spec.image_dir)
    gt_dir = os.path.join(root, spec.gt_dir)
    gts = sorted(f for f in os.listdir(gt_dir) if f.endswith("." + spec.gt_ext))
    pairs = []
    for g in gts:
        base = g[: -len(spec.gt_ext) - 1]
        img = os.path.join(img_dir, base + "." + spec.image_ext)
        if os.path.exists(img):
            pairs.append((img, os.path.join(gt_dir, g)))
    return pairs[:limit] if limit else pairs


def probe_sizes(paths, cache_path: str | None = None) -> list:
    """(h, w) per file from its header (no pixel decode), optionally cached
    on disk as a JSON {basename: [h, w]}, the JAX package's cache file."""
    cache: dict = {}
    if cache_path and os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                cache = json.load(f)
        except (OSError, ValueError):
            cache = {}
    sizes = []
    dirty = False
    for p in paths:
        key = os.path.basename(p)
        if key in cache:
            sizes.append((int(cache[key][0]), int(cache[key][1])))
            continue
        s = probe_size(p)
        cache[key] = s
        sizes.append(s)
        dirty = True
    if cache_path and dirty:
        try:
            os.makedirs(os.path.dirname(cache_path), exist_ok=True)
            with open(cache_path, "w") as f:
                json.dump(cache, f)
        except OSError:
            pass  # read-only dataset root: probe again next run
    return sizes


def load_image(path: str) -> np.ndarray:
    """RGB uint8 (H, W, 3)."""
    return decode_rgb(path)


def load_gt(path: str) -> np.ndarray:
    """Ground-truth id map as int32 (H, W); 16-bit maps load natively, a
    colour map gives its first channel."""
    arr = decode_array(path)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.int32)


def shortest_edge_size(h: int, w: int, short: int, max_size: int) -> tuple[int, int]:
    """detectron2 ResizeShortestEdge target (nh, nw), the one source of this
    rounding for the resize and for canvas sizing."""
    scale = short / min(h, w)
    if h < w:
        newh, neww = short, scale * w
    else:
        newh, neww = scale * h, short
    if max(newh, neww) > max_size:
        s2 = max_size / max(newh, neww)
        newh, neww = newh * s2, neww * s2
    return int(newh + 0.5), int(neww + 0.5)


def resize_shortest_edge(img: np.ndarray, short: int = 640, max_size: int = 2560,
                         interp: str = "bilinear") -> np.ndarray:
    """detectron2 ResizeShortestEdge: a uint8 image bilinear, a label map
    ``interp="nearest"``, as the reference library resizes them."""
    h, w = img.shape[:2]
    newh, neww = shortest_edge_size(h, w, short, max_size)
    if (newh, neww) == (h, w):
        return img
    if interp == "bilinear":
        return resize_bilinear_u8(img, (newh, neww))
    if interp == "nearest":
        return resize_nearest(img, (newh, neww))
    raise ValueError(f"interp must be 'bilinear' or 'nearest', not {interp!r}")


class _PrefetchError:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Background-thread iterator: overlaps host decode with device compute.

    A worker exception (corrupt image, missing file) is raised again in the
    consumer; a dead worker would otherwise leave the consumer blocked on
    the queue forever."""

    def __init__(self, items, fn, depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._n = len(items)

        def work():
            for it in items:
                try:
                    self._q.put(fn(it))
                except BaseException as e:  # noqa: BLE001 — forwarded, not swallowed
                    self._q.put(_PrefetchError(e))
                    return

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def __len__(self):
        return self._n

    def __iter__(self):
        for _ in range(self._n):
            item = self._q.get()
            if isinstance(item, _PrefetchError):
                raise item.exc
            yield item


class GeneratorPrefetcher:
    """Background-thread wrapper for an (infinite) generator: the train loop's
    per-batch decode and augmentation overlap the device step.  Exceptions
    reach the consumer; ``close`` stops the worker."""

    def __init__(self, gen, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def work():
            try:
                for item in gen:
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 — forwarded, not swallowed
                self._q.put(_PrefetchError(e))

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, _PrefetchError):
            raise item.exc
        return item

    def close(self):
        self._stop.set()
