"""Dataset catalog: name -> directories, class list, ignore label, evaluator
(catseg_tpu/data/catalogs.py).

Replaces detectron2's DatasetCatalog/MetadataCatalog registrations (reference:
cat_seg/data/datasets/register_*.py, the names eval.sh uses).  Dataset roots
resolve against $DETECTRON2_DATASETS (default "datasets"); class JSONs against
$CATSEG_CLASS_JSONS, then "./datasets", then the lists the port ships in
``data/class_jsons/``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

_HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    image_dir: str  # relative to dataset root
    gt_dir: str
    class_json: str  # class-list file name
    num_classes: int
    ignore_label: int
    image_ext: str = "jpg"
    gt_ext: str = "png"
    evaluator: str = "sem_seg"  # or "sem_seg_background" (VOCb clamp rule)
    # data/idmaps/ file whose dataset_id -> contiguous mapping the reference
    # registers as stuff_dataset_id_to_contiguous_id; the COCO-format
    # prediction dump inverts it (plain_train_net.py:210-216).  None = the
    # dataset's ids are already contiguous (identity dump).
    idmap_json: str | None = None


# (reference registration file:line follow each entry)
DATASETS: dict[str, DatasetSpec] = {
    s.name: s
    for s in [
        # register_coco_stuff.py:195-211
        DatasetSpec("coco_2017_train_stuff_all_sem_seg", "coco-stuff/images/train2017",
                    "coco-stuff/annotations_detectron2/train2017", "coco.json", 171, 255,
                    idmap_json="coco_stuff_171.json"),  # register_coco_stuff.py:185
        DatasetSpec("coco_2017_test_stuff_all_sem_seg", "coco-stuff/images/val2017",
                    "coco-stuff/annotations_detectron2/val2017", "coco.json", 171, 255,
                    idmap_json="coco_stuff_171.json"),
        # register_ade20k_150.py:16-28
        DatasetSpec("ade20k_150_test_sem_seg", "ADEChallengeData2016/images/validation",
                    "ADEChallengeData2016/annotations_detectron2/validation", "ade150.json", 150, 255),
        # register_ade20k_847.py:28-46 (16-bit TIFF GT)
        DatasetSpec("ade20k_full_sem_seg_freq_val_all", "ADE20K_2021_17_01/images_detectron2/validation",
                    "ADE20K_2021_17_01/annotations_detectron2/validation", "ade847.json", 847, 65535,
                    gt_ext="tif", idmap_json="ade847.json"),  # register_ade20k_847.py:16-20
        # register_pascal_context.py:45-75
        DatasetSpec("context_59_test_sem_seg", "VOCdevkit/VOC2010/JPEGImages",
                    "VOCdevkit/VOC2010/annotations_detectron2/pc59_val", "pc59.json", 59, 255),
        DatasetSpec("context_459_test_sem_seg", "VOCdevkit/VOC2010/JPEGImages",
                    "VOCdevkit/VOC2010/annotations_detectron2/pc459_val", "pc459.json", 459, 459,
                    gt_ext="tif"),
        # register_pascal_20.py:21-49
        DatasetSpec("voc_2012_test_sem_seg", "VOCdevkit/VOC2012/JPEGImages",
                    "VOCdevkit/VOC2012/annotations_detectron2/val", "voc20.json", 20, 255),
        DatasetSpec("voc_2012_test_background_sem_seg", "VOCdevkit/VOC2012/JPEGImages",
                    "VOCdevkit/VOC2012/annotations_detectron2_bg/val", "voc20b.json", 21, 255,
                    evaluator="sem_seg_background"),
        # fork remote-sensing sets
        # register_landdiscover50k.py:26-38
        DatasetSpec("LandDiscover_50K", "LandDiscover50K/TR_Image", "LandDiscover50K/GT_ID",
                    "landdiscover.json", 40, 0, image_ext="png"),
        # register_ISPRS.py:17-29
        DatasetSpec("potsdam_all", "PotsdamSplit/img_dir/val", "PotsdamSplit/ann_dir/val",
                    "potsdam.json", 5, 5, image_ext="png"),
        # register_FLAIR.py:27-35
        DatasetSpec("FLAIR_test", "FLAIR/FLAIR_test/image", "FLAIR/FLAIR_test/mask",
                    "flair.json", 12, 12, image_ext="png"),
        # register_FAST_val.py:22-37
        DatasetSpec("FAST_val", "SAMRS/FAST/val/images", "SAMRS/FAST/val/semlabels/gray",
                    "fast.json", 37, 255, image_ext="png"),
        # register_floodnet.py:36-44
        DatasetSpec("FloodNet", "FloodNet/val+test/img", "FloodNet/val+test/lbl",
                    "floodnet.json", 10, 0),
    ]
}

# eval.sh benchmark aliases (eval.sh:28-103)
BENCHMARKS = {
    "ade150": "ade20k_150_test_sem_seg",
    "ade847": "ade20k_full_sem_seg_freq_val_all",
    "voc20": "voc_2012_test_sem_seg",
    "voc20b": "voc_2012_test_background_sem_seg",
    "pc59": "context_59_test_sem_seg",
    "pc459": "context_459_test_sem_seg",
}


def dataset_root() -> str:
    return os.environ.get("DETECTRON2_DATASETS", "datasets")


def _class_json_search() -> tuple:
    # read per call (not at import), so setting the variable after importing
    # the package works; files a user provides take priority over the
    # shipped lists
    return (os.environ.get("CATSEG_CLASS_JSONS", ""), "datasets", os.path.join(_HERE, "class_jsons"))


def find_class_json(fname: str) -> str:
    search = _class_json_search()
    for base in search:
        if not base:
            continue
        path = os.path.join(base, fname)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"class json {fname!r} not found in {search}")


def load_class_names(fname_or_dataset: str) -> list[str]:
    """A class list by file name ("ade150.json") or dataset name."""
    if fname_or_dataset in DATASETS:
        fname_or_dataset = DATASETS[fname_or_dataset].class_json
    with open(find_class_json(fname_or_dataset)) as f:
        return json.load(f)


def idmap_path(fname: str) -> str:
    """Path of a shipped dataset-id map (``DatasetSpec.idmap_json``)."""
    return os.path.join(_HERE, "idmaps", fname)


def get_dataset(name: str) -> DatasetSpec:
    name = BENCHMARKS.get(name, name)
    if name not in DATASETS:
        raise SystemExit(
            f"unknown dataset/benchmark {name!r}; benchmarks: {sorted(BENCHMARKS)}, "
            f"datasets: {sorted(DATASETS)}"
        )
    return DATASETS[name]
