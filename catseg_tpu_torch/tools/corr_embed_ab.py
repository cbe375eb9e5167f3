"""Kernel #3 (corr embed) of two checkouts, timed on one card at the serving shape.

    python3 -m catseg_tpu_torch.tools.corr_embed_ab --other DIR [--C 128] [--E 512]

``DIR`` is another checkout of this repository, for example the parent
commit unpacked with ``git archive``.  Four processes run in the order
other, this, this, other; each imports its own checkout's
``catseg_tpu_torch`` (building that checkout's kernels) and calls
``kernels.corr_embed.fused_corr_embed``, whose signature both share, on the
same seeded inputs: 10 tiles of a 24x24 grid, T = 150, one prompt, in fp32
and in bf16.  Each times the call as chip_smoke.py [3] does: 20 calls in one
CUDA graph, the median of 10 CUDA-event timed replays, divided by 20.  Each
also hashes its outputs.  The last line is one JSON object: each run's ms
by dtype, and whether the four runs' outputs are bitwise equal.  Needs an
NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

THIS = Path(__file__).resolve().parents[2]
B, T = 10, 150   # the serving shape: 2 images of 5 tiles, ADE-150
CALLS, REPS = 20, 10


def graph_ms(fn) -> float:
    """Device ms of one call: ``CALLS`` calls captured in one CUDA graph, the
    median of ``REPS`` timed replays over ``CALLS``."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / CALLS)
    return statistics.median(times)


def worker(root: Path, C: int, E: int) -> dict:
    """Time and hash ``root``'s corr embed; runs in a process of its own."""
    sys.path.insert(0, str(root))
    from catseg_tpu_torch.kernels import _build, corr_embed

    if not Path(corr_embed.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {corr_embed.__file__}, not the checkout at {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    img = torch.randn(B, 24, 24, E, generator=g)
    txt = corr_embed.l2_normalize(torch.randn(B, T, 1, E, generator=g))
    w = (torch.rand(7, 7, 1, C, generator=g) * 2 - 1) / 7
    b = (torch.rand(C, generator=g) * 2 - 1) / 7
    out = {"root": str(root)}
    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            args = (img.cuda().to(dt), txt.cuda().to(dt), w.cuda(), b.cuda())
            _build.reset_launches()
            y = corr_embed.fused_corr_embed(*args)
            if _build.LAUNCHES["corr_embed"] != 1:
                raise RuntimeError(f"{root}: the wrapper did not launch its kernel")
            name = str(dt).removeprefix("torch.")
            out[f"{name}_sha256"] = hashlib.sha256(y.cpu().view(torch.uint8).numpy().tobytes()).hexdigest()
            out[f"{name}_ms"] = graph_ms(lambda: corr_embed.fused_corr_embed(*args))
            del y, args
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, help="another checkout's root")
    ap.add_argument("--C", type=int, default=128, help="embed channels")
    ap.add_argument("--E", type=int, default=512, help="text width")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker is not None:
        print(json.dumps(worker(a.worker.resolve(), a.C, a.E)))
        return 0
    if not torch.cuda.is_available():
        print("corr_embed_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if a.other is None:
        ap.error("--other is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runs = []
    for tag, root in (("other", a.other), ("this", THIS), ("this", THIS), ("other", a.other)):
        res = subprocess.run([sys.executable, "-P", str(Path(__file__).resolve()), "--worker", str(root.resolve()),
                              "--C", str(a.C), "--E", str(a.E)], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        runs.append({"checkout": tag, **json.loads(res.stdout.strip().splitlines()[-1])})
        print(json.dumps(runs[-1]), flush=True)
    equal = {dt: len({r[f"{dt}_sha256"] for r in runs}) == 1 for dt in ("float32", "bfloat16")}
    print(smi)
    print(json.dumps({"shape": {"tiles": B, "T": T, "C": a.C, "E": a.E}, "card": smi, "bitwise_equal": equal,
                      "ms": [{"checkout": r["checkout"], "float32": r["float32_ms"], "bfloat16": r["bfloat16_ms"]}
                             for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
