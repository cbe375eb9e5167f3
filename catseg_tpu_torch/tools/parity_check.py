"""Real-weights mIoU check against the reference README table
(catseg_tpu/tools/parity_check.py).

    python -m catseg_tpu_torch.tools.parity_check \
        --checkpoint /path/model_base.pth --config vitb384 \
        [--data-root $DETECTRON2_DATASETS] [--tol 0.5] [--limit N] [--benchmarks ade150,...] [--device cpu]

Runs the six-benchmark sweep with the eval.sh protocol (sliding window,
pooling [1,1]) through ``evaluation.harness.evaluate_benchmark``, compares
each mIoU with the published table and prints one PASS / FAIL line per
benchmark and a verdict; exit code 1 on any FAIL.  ``--config vitb384`` is
checked against the CAT-Seg (B) row, ``vitl336`` the CAT-Seg (L) row.  The
published numbers hold for whole sets only, so a ``--limit`` run prints
DELTA lines and no verdict.
"""

from __future__ import annotations

import argparse
import sys

from ..evaluation.harness import evaluate_benchmark
from .common import add_device_arg, load_params, resolve_config

# the reference README's table (CAT-Seg (B) and (L) rows); keys are the
# harness's benchmark names
PUBLISHED_MIOU = {
    "vitb384": {"ade847": 12.0, "pc459": 19.0, "ade150": 31.8, "pc59": 57.5, "voc20": 94.6, "voc20b": 77.3},
    "vitl336": {"ade847": 16.0, "pc459": 23.8, "ade150": 37.9, "pc59": 63.3, "voc20": 97.0, "voc20b": 82.5},
}


def main(argv=None) -> int:
    """Returns the exit code: 1 when a benchmark FAILs, else 0."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arg(ap)
    ap.add_argument("--checkpoint", required=True,
                    help="released model_base.pth / model_large.pth (any format --checkpoint of tools.eval takes)")
    ap.add_argument("--config", default="vitb384", choices=sorted(PUBLISHED_MIOU))
    ap.add_argument("--data-root", default=None, help="defaults to $DETECTRON2_DATASETS")
    ap.add_argument("--tol", type=float, default=0.5, help="PASS tolerance in mIoU points (default 0.5)")
    ap.add_argument("--limit", type=int, default=None, help="cap images per benchmark: DELTA only, no PASS / FAIL")
    ap.add_argument("--benchmarks", default=None, help="comma subset (default: all six published)")
    args = ap.parse_args(argv)

    table = PUBLISHED_MIOU[args.config]
    benches = [b.strip() for b in args.benchmarks.split(",")] if args.benchmarks else list(table)
    cfg = resolve_config(args.config, [])
    model = load_params(args.checkpoint, cfg, device=args.device)

    failed = []
    for bench in benches:
        got = float(evaluate_benchmark(model, cfg, bench, root=args.data_root, limit=args.limit)["mIoU"])
        want = table[bench]
        delta = got - want
        if args.limit:
            status = f"DELTA {delta:+.2f} (--limit {args.limit}: no PASS/FAIL)"
        elif abs(delta) <= args.tol:
            status = f"PASS ({delta:+.2f} within ±{args.tol})"
        else:
            status = f"FAIL ({delta:+.2f} exceeds ±{args.tol})"
            failed.append(bench)
        print(f"{bench:8s} mIoU {got:6.2f}  published {want:6.2f}  {status}", flush=True)

    print("-" * 64)
    if args.limit:
        print(f"smoke run (--limit {args.limit}): the deltas above are indicative only")
    elif failed:
        print(f"PARITY FAIL: {', '.join(failed)} outside ±{args.tol} mIoU")
        return 1
    else:
        print(f"PARITY PASS: all {len(benches)} benchmarks within ±{args.tol} mIoU of the published table")
    return 0


if __name__ == "__main__":
    sys.exit(main())
