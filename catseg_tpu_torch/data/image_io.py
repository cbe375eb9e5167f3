"""Image decoding without an imaging library: JPEG, PNG and TIFF.

Gives the same arrays as the JAX package's ``np.asarray(Image.open(p))``
(``decode_array``) and ``np.asarray(Image.open(p).convert("RGB"))``
(``decode_rgb``), so the port's inputs, and therefore its mIoU, are the JAX
package's bit for bit.

- JPEG: ``csrc/host/image_io.cpp``, libjpeg's default decompression
  (ISLOW IDCT, fancy upsampling, its YCbCr tables) reproduced exactly.
  Arithmetic coding, 12-bit samples, lossless and hierarchical frames,
  CMYK / YCCK and a progressive file that leaves a coefficient not fully
  sent raise ``NotImplementedError``.  EXIF orientation is not applied.
- PNG: inflated with ``zlib``, rows unfiltered in the C++ library.  Bit
  depths 1, 2, 4 (grey and palette), 8 and 16; grey, grey + alpha, palette,
  RGB and RGBA; 16-bit RGB / RGBA / grey + alpha keep the high byte and a
  16-bit grey map stays uint16, as the reference library opens them.  Adam7
  interlacing raises.
- TIFF: uncompressed strips of uint8 / uint16 samples (one channel, or
  three 8-bit), either byte order.  Any compression raises.

The C++ library (with the uint8 resizes of ``data.resize``, the JPEG
encoder of ``data.image_write`` and the COCO RLE codec) is built at first
use by ``g++ -O3 -shared -fPIC -ffp-contract=off`` (no FMA contraction:
the resize's double arithmetic must round as the reference library's) into
``_build/host-<hash of sources and flags>/`` and loaded with ctypes, which releases the GIL during a call, so
decoding in a prefetch thread overlaps the card.  A missing compiler or a
failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
HOST_SRC = _PKG / "csrc" / "host"
BUILD_ROOT = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_lib = None
_lock = threading.Lock()


def _digest() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for p in sorted(HOST_SRC.glob("*.cpp")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_host() -> Path:
    """Compile the host library if this source hash has none yet; its path."""
    out_dir = BUILD_ROOT / f"host-{_digest()}"
    lib = out_dir / "libcatseg_host.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the host image library is built from "
                           f"{HOST_SRC} at first use")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libcatseg_host.{os.getpid()}.{threading.get_ident()}.so"
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), *map(str, sorted(HOST_SRC.glob("*.cpp")))]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("g++ failed building the host image library:\n" + " ".join(cmd) + "\n"
                           + res.stdout + res.stderr[-8000:])
    os.replace(tmp, lib)
    return lib


def host_library() -> ctypes.CDLL:
    """The loaded host library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_host()))
            p, i, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
            ip = ctypes.POINTER(ctypes.c_int)
            lib.catseg_jpeg_info.argtypes = [p, sz, ip, ip, ip, ctypes.c_char_p, i]
            lib.catseg_jpeg_decode.argtypes = [p, sz, p, ctypes.c_char_p, i]
            lib.catseg_png_unfilter.argtypes = [p, i, i, i, p, ctypes.c_char_p, i]
            for fn in (lib.catseg_jpeg_info, lib.catseg_jpeg_decode, lib.catseg_png_unfilter):
                fn.restype = ctypes.c_int
            for fn in (lib.catseg_resize_bilinear_u8, lib.catseg_resize_bicubic_u8):
                fn.argtypes = [p, i, i, i, p, i, i]
                fn.restype = ctypes.c_int
            lib.catseg_jpeg_encode.argtypes = [p, i, i, i, i, ctypes.POINTER(ctypes.c_void_p),
                                               ctypes.POINTER(sz)]
            lib.catseg_jpeg_encode.restype = ctypes.c_int
            lib.catseg_free.argtypes = [p]
            lib.catseg_free.restype = None
            lib.rle_encode.argtypes = [p, i, i, p]
            lib.rle_encode.restype = ctypes.c_int
            lib.rle_decode.argtypes = [p, i, i, i, p]
            lib.rle_decode.restype = None
            _lib = lib
    return _lib


def _check(code: int, err, path: str, what: str) -> None:
    if code == 1:
        raise NotImplementedError(f"{path}: {err.value.decode()} is not supported")
    if code != 0:
        raise ValueError(f"{path}: malformed {what}: {err.value.decode()}")


def _kind(head: bytes, path: str) -> str:
    if head[:2] == b"\xff\xd8":
        return "jpeg"
    if head[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "tiff"
    raise NotImplementedError(f"{path}: not a JPEG, PNG or TIFF file")


# ---------------------------------------------------------------- JPEG


def _jpeg(data: bytes, path: str) -> tuple[np.ndarray, str]:
    lib = host_library()
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(512)
    _check(lib.catseg_jpeg_info(data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c), err, 512),
           err, path, "JPEG")
    out = np.empty((h.value, w.value, c.value), np.uint8)
    _check(lib.catseg_jpeg_decode(data, len(data), out.ctypes.data, err, 512), err, path, "JPEG")
    return (out[..., 0], "L") if c.value == 1 else (out, "RGB")


# ---------------------------------------------------------------- PNG

# colour type -> (samples per pixel, name)
_PNG_TYPES = {0: (1, "L"), 2: (3, "RGB"), 3: (1, "P"), 4: (2, "LA"), 6: (4, "RGBA")}


def _png_chunks(data: bytes, path: str):
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: malformed PNG: no IEND chunk")


def _png(data: bytes, path: str) -> tuple[np.ndarray, str, np.ndarray | None]:
    ihdr, palette, idat = None, None, []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: malformed PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise NotImplementedError(f"{path}: Adam7-interlaced PNG is not supported")
    if ctype not in _PNG_TYPES or depth not in (1, 2, 4, 8, 16) or (depth < 8 and ctype not in (0, 3)) \
            or (ctype == 3 and depth == 16):
        raise ValueError(f"{path}: malformed PNG: colour type {ctype} at bit depth {depth}")
    spp, mode = _PNG_TYPES[ctype]
    rowbytes = (w * spp * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (rowbytes + 1):
        raise ValueError(f"{path}: malformed PNG: image data too short")
    out = np.empty((h, rowbytes), np.uint8)
    err = ctypes.create_string_buffer(512)
    _check(host_library().catseg_png_unfilter(raw, h, rowbytes, max(1, spp * depth // 8), out.ctypes.data, err,
                                              512), err, path, "PNG")
    if depth < 8:
        px = np.unpackbits(out, axis=1).reshape(h, -1, depth)[:, :w]
        px = (px * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1, dtype=np.uint8)
        if mode == "L":   # the reference library scales sub-byte grey to 0..255 (1 bit: bool)
            return (px.astype(bool), "1", None) if depth == 1 else (px * (255 // ((1 << depth) - 1)), "L", None)
        return px, mode, palette
    px = out.reshape(h, w, spp) if depth == 8 else out.view(">u2").reshape(h, w, spp)
    if depth == 16:
        if mode == "L":
            return px[..., 0].astype(np.uint16), "I;16", None
        px = (px >> 8).astype(np.uint8)    # 16-bit colour opens as its high bytes
        if mode == "LA":                   # ... and grey + alpha as RGBA
            return np.concatenate([px[..., :1]] * 3 + [px[..., 1:]], axis=-1), "RGBA", None
    return (px[..., 0] if spp == 1 else px), mode, palette


# ---------------------------------------------------------------- TIFF

_TIFF_TYPES = {1: "B", 3: "H", 4: "I", 16: "Q"}   # BYTE, SHORT, LONG, LONG8


def _tiff_tags(data: bytes, path: str) -> dict:
    order = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack(order + "I", data[4:8])
    (n,) = struct.unpack(order + "H", data[ifd:ifd + 2])
    tags = {}
    for e in range(n):
        off = ifd + 2 + 12 * e
        tag, typ, count = struct.unpack(order + "HHI", data[off:off + 8])
        if typ not in _TIFF_TYPES:
            continue
        fmt = _TIFF_TYPES[typ]
        size = struct.calcsize(fmt) * count
        if size <= 4:
            raw = data[off + 8:off + 8 + size]
        else:
            (ptr,) = struct.unpack(order + "I", data[off + 8:off + 12])
            raw = data[ptr:ptr + size]
        tags[tag] = struct.unpack(order + fmt * count, raw)
    tags["order"] = order
    return tags


def _tiff(data: bytes, path: str) -> tuple[np.ndarray, str, None]:
    t = _tiff_tags(data, path)
    w, h = t[256][0], t[257][0]
    comp = t.get(259, (1,))[0]
    if comp != 1:
        raise NotImplementedError(f"{path}: TIFF compression {comp} is not supported (uncompressed only)")
    bits = t.get(258, (1,))
    spp = t.get(277, (1,))[0]
    photometric = t.get(262, (1,))[0]
    if t.get(339, (1,))[0] != 1 or t.get(284, (1,))[0] != 1 or not (
            (spp == 1 and bits[0] in (8, 16) and photometric == 1)
            or (spp == 3 and set(bits) == {8} and photometric == 2)):
        raise NotImplementedError(f"{path}: TIFF layout (samples {spp}, bits {bits}, photometric "
                                  f"{photometric}) is not supported: unsigned uint8 / uint16 grey or 8-bit RGB, "
                                  "contiguous")
    pixels = b"".join(data[o:o + n] for o, n in zip(t[273], t[279]))
    dt = np.dtype(np.uint8) if bits[0] == 8 else np.dtype(t["order"] + "u2")
    arr = np.frombuffer(pixels, dt, count=w * h * spp).reshape(h, w, spp)
    if spp == 3:
        return arr.copy(), "RGB", None
    return arr[..., 0].astype(np.uint16 if bits[0] == 16 else np.uint8), ("I;16" if bits[0] == 16 else "L"), None


# ---------------------------------------------------------------- API


def decode(path: str) -> tuple[np.ndarray, str, np.ndarray | None]:
    """(pixels, mode, palette): the file's samples as the reference library
    holds them, its mode name ("1", "L", "LA", "P", "RGB", "RGBA", "I;16") and
    the PNG palette ((n, 3) uint8) of a "P" image."""
    with open(path, "rb") as f:
        data = f.read()
    kind = _kind(data[:8], path)
    if kind == "jpeg":
        return (*_jpeg(data, path), None)
    return _png(data, path) if kind == "png" else _tiff(data, path)


def decode_array(path: str) -> np.ndarray:
    """What ``np.asarray`` of the opened image gives: palette indices, uint16
    grey, (H, W, C) colour."""
    return decode(path)[0]


def decode_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as ``convert("RGB")``: grey replicated, alpha
    dropped, a palette looked up (indices past its end are black), 16-bit
    grey clipped to 255."""
    px, mode, palette = decode(path)
    if mode == "RGB":
        return px
    if mode == "RGBA":
        return np.ascontiguousarray(px[..., :3])
    if mode == "P":
        lut = np.zeros((256, 3), np.uint8)
        if palette is not None:
            lut[:len(palette)] = palette[:256]
        return lut[px]
    if mode == "LA":
        px = px[..., 0]
    elif mode == "1":
        px = px.astype(np.uint8) * 255
    elif mode == "I;16":
        px = np.minimum(px, 255).astype(np.uint8)
    return np.repeat(px[..., None], 3, axis=-1)


def probe_size(path: str) -> tuple[int, int]:
    """(h, w) from the PNG IHDR, the JPEG frame header or the TIFF tags,
    without decoding the pixels."""
    with open(path, "rb") as f:
        head = f.read(32)
        kind = _kind(head[:8], path)
        if kind == "png":
            w, h = struct.unpack(">II", head[16:24])
            return h, w
        if kind == "tiff":
            f.seek(0)
            t = _tiff_tags(f.read(), path)
            return t[257][0], t[256][0]
        f.seek(2)
        while True:
            b = f.read(1)
            if not b:
                raise ValueError(f"{path}: malformed JPEG: no frame header")
            if b != b"\xff":
                continue
            m = f.read(1)
            while m == b"\xff":
                m = f.read(1)
            m = m[0] if m else 0xD9
            if m == 0xD9 or m == 0xDA:
                raise ValueError(f"{path}: malformed JPEG: no frame header before the scan")
            if 0xD0 <= m <= 0xD7 or m == 0x01:
                continue
            (n,) = struct.unpack(">H", f.read(2))
            if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                _, h, w = struct.unpack(">BHH", f.read(5))
                return h, w
            f.seek(n - 2, 1)
