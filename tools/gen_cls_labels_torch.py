"""Regenerate ``cls_labels_onehot.npy`` (image name -> multi-hot foreground
label vector) from segmentation masks, with the PyTorch port's modules
(counterpart of ``tools/gen_cls_labels.py``).

    python tools/gen_cls_labels_torch.py --dataset coco \
        --data-folder coco2014 --list-folder datasets/coco

The reference ships this file for VOC; its COCO counterpart is not in the
snapshot, and the COCO datasets derive the labels from the masks without it.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from PIL import Image


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", choices=["voc", "coco"], required=True)
    p.add_argument("--data-folder", required=True)
    p.add_argument("--label-folder", default=None,
                   help="mask root (defaults: VOC SegmentationClassAug / "
                        "COCO ../SegmentationClass)")
    p.add_argument("--list-folder", required=True)
    p.add_argument("--splits", nargs="+", default=None)
    args = p.parse_args(argv)

    from dupl_tpu_torch.data.coco import _subdir, default_label_folder
    from dupl_tpu_torch.data.voc import load_name_list, onehot_from_mask

    if args.dataset == "voc":
        num_classes = 21
        splits = args.splits or ["train_aug", "val"]
        label_root = args.label_folder or os.path.join(
            args.data_folder, "SegmentationClassAug")

        def mask_path(name):
            return os.path.join(label_root, name + ".png")
    else:
        num_classes = 81
        splits = args.splits or ["train", "val", "val_part"]
        label_root = args.label_folder or default_label_folder(
            args.data_folder)

        def mask_path(name):
            return os.path.join(label_root, _subdir(name), name + ".png")

    table = {}
    for split in splits:
        names = load_name_list(os.path.join(args.list_folder, split + ".txt"))
        for name in names:
            if name not in table:
                mask = np.asarray(Image.open(mask_path(name)))
                table[name] = onehot_from_mask(mask, num_classes).astype(
                    np.uint8)
        print(f"{split}: {len(names)} images")

    out = os.path.join(args.list_folder, "cls_labels_onehot.npy")
    np.save(out, table, allow_pickle=True)
    print(f"wrote {out} ({len(table)} entries)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
