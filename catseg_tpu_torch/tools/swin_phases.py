"""Where the bf16 Swin kernel (#4) spends a window's time, phase by phase.

    python -m catseg_tpu_torch.tools.swin_phases [--reps 5]

Builds csrc/swin_block.cu twice more as timing builds (into
``catseg_tpu_torch/_build/swin_block_phases/<hash>/``, never the port's library):
``clocks`` with CATSEG_SWIN_PHASE_CLOCKS (thread 0 of every CTA adds the
clock64 cycles between the kernel's barriers, per phase), and ``l1`` with
CATSEG_SWIN_WEIGHTS_FROM_L1 as well (every weight fragment read from 8 KB a
matrix that stays in L1: wrong results, the floor of what a faster weight
path, a cp.async ring included, could give).  Runs one block at the serving
slab (10 tiles x 150 classes on the 24 x 24 grid, bf16, guidance) at shift
0 and 6 through the port's kernel and both timing builds, and prints one
JSON line per (build, shift): the launch's ms (median of ``--reps``
CUDA-event timings; for the port's build also ``wrapper_ms``, the call as
the model makes it, weights cast and packed inside the timed window) and,
per phase, the mean cycles a CTA, its share of the CTA's time, and the
cycles the phase's tensor-core work would take at the SM's dense bf16
peak.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess

import torch

from ..kernels import _build, swin_block

PHASES = ("gather", "ln1", "qkv", "attention", "proj", "ln2", "fc1", "fc2", "fc2_epilogue", "scatter")
# a window's tensor-core operations per phase (144 tokens, C 128, 4 heads of 32, hidden 512)
N, C, HID = 144, 128, 512
FLOPS = {"qkv": 2 * N * C * 3 * C, "attention": 4 * 2 * (2 * N * N * 32), "proj": 2 * N * C * C,
         "fc1": 2 * N * C * HID, "fc2": 2 * N * HID * C}
# H100 SXM dense bf16 tensor-core rate per SM and cycle: 989.4e12 / (132 SMs x 1.83 GHz)
SM_FLOPS_PER_CYCLE = 4096
BUILDS = {"clocks": ("-DCATSEG_SWIN_PHASE_CLOCKS",),
          "l1": ("-DCATSEG_SWIN_PHASE_CLOCKS", "-DCATSEG_SWIN_WEIGHTS_FROM_L1")}


def timing_builds(stem: str, builds: dict[str, tuple], entry: str, cycles_fn: str) -> dict[str, ctypes.CDLL]:
    """csrc/<stem>.cu as one library per timing build (``builds``: name ->
    extra nvcc defines; one nvcc each, started together) under
    ``_build/<stem>_phases/<hash>/``, loaded with C entry point ``entry`` and
    the phase-cycle reader ``cycles_fn`` bound."""
    srcs = [_build.CSRC / f"{stem}.cu", _build.CSRC / "errors.cu"]
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for p in sorted(_build.CSRC.glob("*.cuh")) + srcs:
        h.update(p.read_bytes())
    out_dir = _build.BUILD_ROOT / f"{stem}_phases" / h.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, defs in builds.items():
        lib = out_dir / f"lib{name}.so"
        if not lib.exists():
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-shared", "-o", str(lib), *map(str, srcs)]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{log[-8000:]}")
    libs = {}
    for name in builds:
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        fn = getattr(lib, entry)
        fn.argtypes = [_build._CTYPE[k] for k in _build._SIGNATURES[entry]] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        getattr(lib, cycles_fn).argtypes = [ctypes.c_void_p]
        getattr(lib, cycles_fn).restype = ctypes.c_int
        lib.catseg_error_string.argtypes = [ctypes.c_int]
        lib.catseg_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def build() -> dict[str, ctypes.CDLL]:
    """Both timing builds of the Swin kernel, loaded."""
    return timing_builds("swin_block", BUILDS, "catseg_swin_block", "catseg_swin_phase_cycles")


def cycles(lib, n: int = len(PHASES), fn: str = "catseg_swin_phase_cycles") -> list[int]:
    """Per-phase cycle sums of ``n`` phases and the CTA count since the last read (then 0)."""
    buf = (ctypes.c_ulonglong * (n + 1))()
    err = getattr(lib, fn)(ctypes.addressof(buf))
    if err:
        raise RuntimeError(f"{fn}: cudaError {err}")
    return list(buf)


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def inputs(dev, seed: int = 0):
    """The serving slab (10 tiles, 150 classes, 24 x 24, 128) in bf16, its
    guidance halves and one block's parameters, from ``seed``."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, bound=None):
        bound = shape[0] ** -0.5 if bound is None else bound
        return ((torch.rand(*shape, generator=g) * 2 - 1) * bound).to(dev)

    x = torch.randn(10, 150, 24, 24, C, generator=g).to(dev, torch.bfloat16)
    qg, kg = ((torch.randn(10, 24, 24, C, generator=g) * 0.5).to(dev, torch.bfloat16) for _ in range(2))
    p = {"ln1_g": 1 + u(C, bound=0.1), "ln1_b": u(C, bound=0.1), "qkv_w": u(C, 3 * C),
         "qkv_b": u(3 * C, bound=0.1), "proj_w": u(C, C), "proj_b": u(C, bound=0.1),
         "ln2_g": 1 + u(C, bound=0.1), "ln2_b": u(C, bound=0.1), "fc1_w": u(C, HID),
         "fc1_b": u(HID, bound=0.1), "fc2_w": u(HID, C), "fc2_b": u(C, bound=0.1)}
    return x, qg, kg, p


def measure(reps: int) -> list[dict]:
    dev = torch.device("cuda")
    libs = build()
    x, qg, kg, p = inputs(dev)
    rows = []
    for shift in (0, 6):
        _, args = swin_block.block_args(x, qg, kg, p, shift)
        # the port's own library on the same prepared arguments: what the stamps cost
        port_ms = time_ms(lambda: _build.launch("catseg_swin_block", *args), reps)
        # the wrapper as the model calls it (weights cast and packed each call)
        wrapper_ms = time_ms(lambda: swin_block._swin_block_cuda(x, qg, kg, p, shift), reps)
        rows.append({"build": "port", "shift": shift, "ms": port_ms, "wrapper_ms": wrapper_ms})
        for name, lib in libs.items():
            run = lambda: _build.launch("catseg_swin_block", *args, lib=lib)  # noqa: E731
            run()
            torch.cuda.synchronize()
            cycles(lib)
            ms = time_ms(run, reps)
            sums = cycles(lib)
            ctas = sums[-1]
            per = [s / ctas for s in sums[:-1]]
            total = sum(per)
            rows.append({
                "build": name, "shift": shift, "ms": ms, "ctas": ctas, "cycles_per_cta": total,
                "phases": {ph: {"cycles": c, "share": c / total,
                                "tc_peak_cycles": FLOPS[ph] / SM_FLOPS_PER_CYCLE if ph in FLOPS else None}
                           for ph, c in zip(PHASES, per)}})
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("swin_phases needs an NVIDIA GPU")
    for row in measure(args.reps):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
