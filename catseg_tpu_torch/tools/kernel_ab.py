"""Kernel cases of two checkouts, timed on one card.

    python3 -m catseg_tpu_torch.tools.kernel_ab --other DIR --cases window_attention,linear_attention

``DIR`` is another checkout of this repository, for example the parent
commit unpacked with ``git archive``.  Four processes run in the order
other, this, this, other; each imports its own checkout's
``catseg_tpu_torch`` (building that checkout's kernels), makes its
``kernels.selfcheck.cases`` at full size in fp32 and in bf16 (seeded, so
both checkouts give the same inputs to a case both define) and, for each
named case, calls the kernel once (it must raise its kernel's launch count),
hashes the output and times the call as chip_smoke.py [3] times a short
one: 20 calls in one CUDA graph, the median of 10 CUDA-event timed
replays, divided by 20.  The last line is one JSON object: each run's ms by
case and dtype, and whether the four runs' outputs are bitwise equal.
Needs an NVIDIA GPU.
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
CALLS, REPS = 20, 10
DTYPES = (torch.float32, torch.bfloat16)


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
    del graph
    return statistics.median(times)


def _digest(out) -> str:
    h = hashlib.sha256()
    for t in (out[k] for k in sorted(out)) if isinstance(out, dict) else (out,):
        h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def worker(root: Path, names: list[str]) -> dict:
    """Time and hash ``root``'s cases; runs in a process of its own."""
    sys.path.insert(0, str(root))
    from catseg_tpu_torch.kernels import _build, selfcheck

    if not Path(selfcheck.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {selfcheck.__file__}, not the checkout at {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": str(root)}
    for dt in DTYPES:
        cases = selfcheck.cases(torch.device("cuda"), dt)
        for name in names:
            case = cases[name]
            kernel = name.split("@")[0]
            _build.reset_launches()
            with torch.no_grad():
                y = case.kernel()
            torch.cuda.synchronize()
            if _build.LAUNCHES[kernel] == 0:
                raise RuntimeError(f"{root}: {name} did not launch its kernel")
            key = f"{name} {str(dt).removeprefix('torch.')}"
            out[f"{key} sha256"] = _digest(y)
            del y
            with torch.no_grad():
                out[f"{key} ms"] = graph_ms(case.kernel)
        del cases
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, help="another checkout's root")
    ap.add_argument("--cases", default="corr_embed", help="comma-separated names of selfcheck.cases")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    names = a.cases.split(",")
    if a.worker is not None:
        print(json.dumps(worker(a.worker.resolve(), names)))
        return 0
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if a.other is None:
        ap.error("--other is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runs = []
    for tag, root in (("other", a.other), ("this", THIS), ("this", THIS), ("other", a.other)):
        res = subprocess.run([sys.executable, "-P", str(Path(__file__).resolve()), "--worker", str(root.resolve()),
                              "--cases", a.cases], capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return res.returncode
        runs.append({"checkout": tag, **json.loads(res.stdout.strip().splitlines()[-1])})
        print(json.dumps(runs[-1]), flush=True)
    keys = [f"{n} {str(dt).removeprefix('torch.')}" for n in names for dt in DTYPES]
    print(smi)
    print(json.dumps({"card": smi, "bitwise_equal": {k: len({r[f"{k} sha256"] for r in runs}) == 1 for k in keys},
                      "ms": [{"checkout": r["checkout"], **{k: r[f"{k} ms"] for k in keys}} for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
