"""Re-render a dumped predictions JSON into pred / GT overlay panels
(catseg_tpu/tools/viz_results.py; the reference's
visualize_json_results.py:1-127).

Loads the sem_seg_predictions.json written by ``tools.eval
--dump-predictions``, groups the per-category RLE records by file name,
rebuilds each image's argmax map from the masks, and writes [image | pred
overlay | GT overlay] strips as ``{basename}.jpg``.

    python -m catseg_tpu_torch.tools.viz_results --input preds.json \\
        --output viz_out --benchmark voc20 [--data-root D] [--limit 50]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

from ..data.catalogs import get_dataset
from ..data.loader import list_dataset, load_gt, load_image
from ..evaluation.coco_dump import dataset_id_map, rle_decode
from ..infer.visualize import save_visual


def render_predictions_json(input_json: str, output: str, benchmark: str, root: str | None = None,
                            limit: int = 50) -> int:
    """Returns the number of panels written (the reference caps at 50)."""
    spec = get_dataset(benchmark)
    with open(input_json) as f:
        records = json.load(f)
    by_file: dict[str, list] = defaultdict(list)
    for r in records:
        by_file[r["file_name"]].append(r)

    gt_by_img = dict(list_dataset(spec, root=root))
    os.makedirs(output, exist_ok=True)
    inv = dataset_id_map(spec)  # contiguous -> dataset
    to_contig = {v: k for k, v in inv.items()} if inv else None
    n = 0
    for fname, recs in by_file.items():
        if n >= limit:
            break
        if fname not in gt_by_img:
            continue
        img = load_image(fname)
        gt = load_gt(gt_by_img[fname])
        # unpredicted pixels show as ignore; category_id carries DATASET ids
        # for benchmarks with an id map (coco-stuff / ade847,
        # plain_train_net.py:210-216): back to contiguous ids for the palette
        shape = rle_decode(recs[0]["segmentation"]).shape
        sem = np.full(shape, spec.ignore_label, np.int32)
        for r in recs:
            cat = r["category_id"]
            if to_contig:
                cat = to_contig.get(cat, cat)
            sem[rle_decode(r["segmentation"]).astype(bool)] = cat
        base = os.path.splitext(os.path.basename(fname))[0]
        save_visual(img, sem, gt, os.path.join(output, base + ".jpg"), spec.num_classes, spec.ignore_label)
        n += 1
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="predictions json (eval --dump-predictions)")
    ap.add_argument("--output", required=True, help="output directory")
    ap.add_argument("--benchmark", required=True, help="dataset name (palette/ignore/classes)")
    ap.add_argument("--data-root", default=None, help="defaults to $DETECTRON2_DATASETS")
    ap.add_argument("--limit", type=int, default=50)
    args = ap.parse_args(argv)
    n = render_predictions_json(args.input, args.output, args.benchmark, root=args.data_root, limit=args.limit)
    print(f"wrote {n} panels to {args.output}")
    return n


if __name__ == "__main__":
    main()
