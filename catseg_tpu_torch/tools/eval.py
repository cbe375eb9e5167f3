"""Benchmark evaluation CLI, the eval.sh equivalent (catseg_tpu/tools/eval.py).

    python -m catseg_tpu_torch.tools.eval --config vitb384 --checkpoint model.pth \
        --benchmarks ade150,ade847,voc20,voc20b,pc59,pc459 [--limit N] [--device cpu] [KEY=VALUE ...]

Runs each benchmark with the eval.sh protocol (sliding window, pooling
[1,1], the benchmark's class JSON; datasets under $DETECTRON2_DATASETS or
--data-root) and prints a copypaste line per benchmark.  With more than one
GPU visible it starts one worker per GPU in an NCCL process group
(``parallel.mesh.spawn``), and each benchmark runs sharded over the ranks
(``evaluation.distributed``); rank 0 prints and writes.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

from ..evaluation.harness import evaluate_benchmark
from ..parallel.mesh import rank, spawn
from .common import add_device_arg, load_params, resolve_config

DEFAULT_BENCHMARKS = "ade150,ade847,voc20,voc20b,pc59,pc459"


def main(argv=None) -> dict:
    """Returns {benchmark: the harness's metrics dict, ``_conf`` included}
    (rank 0's, every rank's being the same)."""
    args = _parser().parse_args(argv)
    n = torch.cuda.device_count() if args.device == "cuda" else 1
    if n > 1:
        return spawn(_run, n, args, backend="nccl")[0]
    return _run(args)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    ap.add_argument("--config", default="vitb384")
    ap.add_argument("--checkpoint", default=None,
                    help="a released / OpenAI / open_clip .pth, .pt or .bin, the port's .pth, or a catseg_tpu .npz")
    ap.add_argument("--benchmarks", default=DEFAULT_BENCHMARKS)
    ap.add_argument("--data-root", default=None, help="defaults to $DETECTRON2_DATASETS")
    ap.add_argument("--limit", type=int, default=None, help="cap images per benchmark")
    ap.add_argument("--output", default=None, help="write metrics json here")
    ap.add_argument("--whole-image", action="store_true", help="non-sliding branch")
    ap.add_argument("--dump-visuals", type=int, default=0,
                    help="save the first N [image | pred | GT] overlay strips under eval_visuals/")
    ap.add_argument("--dump-predictions", default=None, help="COCO-RLE predictions json")
    ap.add_argument("--seen-indexes", default=None, help="json list for gzero seen/unseen split")
    ap.add_argument("--unseen-indexes", default=None)
    ap.add_argument("--tta", action="store_true",
                    help="multi-scale + hflip TTA (DatasetMapperTTA defaults: 9 scales x flip)")
    ap.add_argument("--eval-batch", type=int, default=2, help="images per model forward (sliding eval)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler chrome trace of the first benchmark here")
    ap.add_argument("overrides", nargs="*", help="config KEY=VALUE overrides")
    return ap


def _run(args) -> dict:
    """The run of one rank (of one process outside a group)."""
    main_rank = rank() == 0
    cfg = resolve_config(args.config, args.overrides)
    model = load_params(args.checkpoint, cfg, device=args.device)

    if args.benchmarks.strip() == "all":
        args.benchmarks = DEFAULT_BENCHMARKS
    from ..utils.profiling import trace

    results, full = {}, {}
    for i, bench in enumerate(args.benchmarks.split(",")):
        bench = bench.strip()
        prof = trace(args.profile) if (args.profile and i == 0) else contextlib.nullcontext()
        with prof:
            m = evaluate_benchmark(model, cfg, bench, root=args.data_root, limit=args.limit,
                                   sliding=not args.whole_image, dump_visuals=args.dump_visuals,
                                   dump_predictions=args.dump_predictions, tta=args.tta,
                                   eval_batch=args.eval_batch)
        if args.seen_indexes and args.unseen_indexes:
            # gzero: seen/unseen/harmonic IoU split (plain_train_net.py:48-228)
            from ..evaluation.miou import gzero_metrics

            with open(args.seen_indexes) as f:
                seen = json.load(f)
            with open(args.unseen_indexes) as f:
                unseen = json.load(f)
            gz = gzero_metrics(m["_conf"], seen, unseen)
            m.update({k: gz[k] for k in ("mIoU_seen", "mIoU_unseen", "hIoU")})
        full[bench] = m
        results[bench] = {k: float(v) for k, v in m.items()
                          if not k.startswith("_") and getattr(v, "ndim", 0) == 0}
        if not main_rank:
            continue
        print(f"copypaste: {bench}: mIoU={m['mIoU']:.4f},fwIoU={m['fwIoU']:.4f},"
              f"mACC={m['mACC']:.4f},pACC={m['pACC']:.4f}")
        if "hIoU" in m:
            print(f"copypaste-gzero: {bench}: seen={m['mIoU_seen']:.4f},"
                  f"unseen={m['mIoU_unseen']:.4f},hIoU={m['hIoU']:.4f}")
    if args.output and main_rank:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return full


if __name__ == "__main__":
    main()
