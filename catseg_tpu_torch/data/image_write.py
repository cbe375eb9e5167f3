"""Image files without an imaging library: JPEG and PNG writers.

:func:`save_image` picks the format by the path's suffix, as the JAX
package's ``Image.fromarray(arr).save(path)`` does:

- ``.jpg`` / ``.jpeg``: a baseline JFIF at libjpeg's defaults, which the
  reference library's save uses with no options: quality 75, YCbCr 4:2:0
  (one grey component for an (H, W) array), islow DCT, the standard
  Huffman tables; encoded by ``csrc/host/image_write.cpp`` (its note lists
  each step's source), so a decoder reads back the pixels the reference
  library's own file of the same array decodes to.
- ``.png``: 8-bit grey for (H, W), RGB for (H, W, 3), filter 0 on every row,
  zlib at its default level; lossless.

Any other suffix raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib

import numpy as np

from .image_io import host_library


def _pixels(arr: np.ndarray) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"an image is uint8 (H, W) or (H, W, 3); got {arr.dtype} {arr.shape}")
    return np.ascontiguousarray(arr)


def encode_jpeg(arr: np.ndarray, quality: int = 75) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> baseline JPEG bytes."""
    arr = _pixels(arr)
    H, W = arr.shape[:2]
    C = 1 if arr.ndim == 2 else 3
    buf, size = ctypes.c_void_p(), ctypes.c_size_t()
    lib = host_library()
    code = lib.catseg_jpeg_encode(arr.ctypes.data, H, W, C, quality, ctypes.byref(buf), ctypes.byref(size))
    if code != 0:
        raise ValueError(f"JPEG encoder refused a {arr.shape} image at quality {quality} (code {code})")
    try:
        return ctypes.string_at(buf, size.value)
    finally:
        lib.catseg_free(buf)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W) uint8 -> 8-bit grey PNG, (H, W, 3) -> RGB; filter 0 on every row."""
    arr = _pixels(arr)
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    colour = 0 if arr.ndim == 2 else 2
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


_ENCODERS = {".jpg": encode_jpeg, ".jpeg": encode_jpeg, ".png": encode_png}


def save_image(path: str | os.PathLike, arr: np.ndarray) -> None:
    """Write ``arr`` to ``path`` in the format its suffix names (case-blind):
    .jpg / .jpeg or .png."""
    suffix = os.path.splitext(str(path))[1].lower()
    if suffix not in _ENCODERS:
        raise NotImplementedError(f"{path}: cannot write {suffix or 'a file without a suffix'!r}; "
                                  "the port writes .jpg, .jpeg and .png")
    data = _ENCODERS[suffix](arr)
    with open(path, "wb") as f:
        f.write(data)
