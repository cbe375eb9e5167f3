"""Build, load and launch the port's CUDA kernels; count every launch.

Each ``catseg_tpu_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
process, all started together, and one more ``nvcc`` links the objects into
a shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), loaded with ``ctypes``.  The build runs at first use,
into ``catseg_tpu_torch/_build/<hash>/`` keyed by a hash of the sources and
the flags, so an edited source rebuilds and an unchanged one is reused.

Every C entry point returns a ``cudaError_t`` (0 on success) taken from
``cudaGetLastError()`` right after its launch; :func:`launch` raises on any
other value — a refused launch (too many threads, too much shared memory)
never runs and a later synchronize would not report it.

``LAUNCHES`` holds one integer per kernel; a wrapper adds one where it
launches its kernel and nowhere else, so a run can prove which kernels its
main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

# kernel name -> launches since the last reset_launches()
LAUNCHES: dict[str, int] = {
    "layer_norm": 0, "dense_attention": 0, "corr_embed": 0,
    "swin_block": 0, "class_layer": 0, "decoder": 0,
    "swin_block_bwd": 0, "class_layer_bwd": 0, "decoder_bwd": 0,
    "window_attention": 0, "mlp": 0, "linear_attention": 0,
}
# the default configuration's forward and backward kernels
FORWARD = ("layer_norm", "dense_attention", "corr_embed", "swin_block", "class_layer", "decoder")
BACKWARD = ("swin_block_bwd", "class_layer_bwd", "decoder_bwd")
# the kernels of the aggregator's unfused stages (core/aggregator.py routes a
# stage there only where its fused kernel does not take the geometry, or with
# attention_type="full"); the default configuration never launches them
UNFUSED = ("window_attention", "mlp", "linear_attention")

# C entry points and their argument kinds: "p" pointer, "i" int, "f" float.
# The stream is always the last argument (a pointer).
_SIGNATURES = {
    "catseg_layer_norm": "ppppiifi",
    "catseg_dense_attention": "ppppiiiiifi",
    "catseg_corr_embed": "pppppp" + "iiiiiii",
    "catseg_swin_block": "pppp" + "p" * 12 + "iiiiiii",
    "catseg_class_layer": "pppppp" + "p" * 10 + "iiiifi",
    "catseg_decoder": "ppppp" + "p" * 18 + "iiii",
    "catseg_swin_block_bwd": "p" * 26 + "iiiiiii",
    "catseg_class_layer_bwd": "p" * 26 + "iiiifi",
    "catseg_decoder_bwd": "p" * 39 + "iii",
    "catseg_window_attention": "ppppp" + "iiiii" + "iii" + "fi",
    "catseg_mlp": "pppppp" + "iiiiii",
    "catseg_linear_attention": "pppp" + "iiii" + "fi",
}
# workspace sizes (fp32 elements) of the backward entry points (int arguments)
_WORKSPACE = {"catseg_swin_block_bwd_workspace": 5, "catseg_class_layer_bwd_workspace": 4,
              "catseg_decoder_bwd_workspace": 2}
# entry points that take each tensor's row stride as an argument
ROW_STRIDED = frozenset({"catseg_window_attention"})
_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}

_lib = None
_lock = threading.Lock()
_count_lock = threading.Lock()   # the tile-sharded path launches from one thread per device


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels are built from source at first use")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return its path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "libcatseg_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    log, objs, procs = [], [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    failed = []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out[-8000:])
    tmp = out_dir / f"libcatseg_kernels.{tag}.so"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr[-8000:])
    (out_dir / "nvcc.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, kinds in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [_CTYPE[k] for k in kinds] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            lib.catseg_error_string.argtypes = [ctypes.c_int]
            lib.catseg_error_string.restype = ctypes.c_char_p
            lib.catseg_decoder_blocks.argtypes = [ctypes.c_int]
            lib.catseg_decoder_blocks.restype = ctypes.c_int
            lib.catseg_decoder_scratch_elems.argtypes = []
            lib.catseg_decoder_scratch_elems.restype = ctypes.c_int
            lib.catseg_window_attention_tensor_cores.argtypes = [ctypes.c_int] * 4
            lib.catseg_window_attention_tensor_cores.restype = ctypes.c_int
            for name, n in _WORKSPACE.items():
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_int] * n
                fn.restype = ctypes.c_longlong
            _lib = lib
    return _lib


def rows_evenly_strided(t) -> bool:
    """Whether t is contiguous but for its row stride: unit stride in the
    last dimension, every other dimension packed over the one after it."""
    return t.dim() >= 2 and t.stride(-1) == 1 and all(
        t.stride(i) == t.stride(i + 1) * t.size(i + 1) for i in range(t.dim() - 2))


def launch(name: str, *args, lib: ctypes.CDLL | None = None) -> None:
    """Call C entry point ``name`` (of ``lib``, by default the port's
    :func:`library`) on the current stream of its tensors' device.

    Tensor arguments pass as device pointers; they must be contiguous (an
    entry point in ``ROW_STRIDED``, which takes row strides, also takes rows
    evenly strided) and all on one CUDA device (a host pointer would fault
    inside the kernel).  ``None`` passes a null pointer.  Raises on a nonzero
    ``cudaError_t``."""
    import torch

    device = None
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if not a.is_cuda or (device is not None and a.device != device):
                raise ValueError(f"{name}: tensors must all be on one CUDA device; got {a.device} "
                                 f"after {device}")
            if not (a.is_contiguous() or (name in ROW_STRIDED and rows_evenly_strided(a))):
                raise ValueError(f"{name}: tensor arguments must be contiguous")
            device = a.device
            a = a.data_ptr()
        cargs.append(a)
    if device is None:
        raise ValueError(f"{name}: no tensor argument")
    lib = lib or library()
    with torch.cuda.device(device):
        err = getattr(lib, name)(*cargs, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.catseg_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({msg})")
