"""Pack a dataset split into ``.duplrec`` shards with the PyTorch port
(counterpart of ``tools/pack_records.py``; the format is described in
``dupl_tpu_torch/data/records.py``).

    python tools/pack_records_torch.py --dataset voc --data-folder VOC2012 \
        --list-folder datasets/voc --split train_aug --out voc_train.duplrec

``tools/train_torch.py --train-records/--val-records`` and
``tools/eval_seg_torch.py --records`` then read the shard (or a glob of the
``--shards N`` pieces) in place of the directory tree.  A shard is the same
bytes as the JAX package's packer writes for the same split.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", choices=["voc", "coco"], default="voc")
    p.add_argument("--data-folder", required=True)
    p.add_argument("--list-folder", required=True)
    p.add_argument("--split", required=True,
                   help="name-list file stem, e.g. train_aug / val / train")
    p.add_argument("--out", required=True, help="output .duplrec path")
    p.add_argument("--label-folder", default=None,
                   help="COCO mask root (default: sibling SegmentationClass)")
    p.add_argument("--no-masks", action="store_true",
                   help="skip packing segmentation masks (cls-only training)")
    p.add_argument("--no-cls", action="store_true",
                   help="skip embedding image-level one-hot labels")
    p.add_argument("--shards", type=int, default=1,
                   help="split the output into N contiguous shard files "
                        "(-NNNNN-of-NNNNN suffix); read back with a glob")
    args = p.parse_args(argv)

    from dupl_tpu_torch.data import records

    if args.dataset == "voc":
        n = records.pack_voc(args.data_folder, args.list_folder, args.split,
                             args.out, with_labels=not args.no_masks,
                             with_cls=not args.no_cls, shards=args.shards)
    else:
        n = records.pack_coco(args.data_folder, args.list_folder, args.split,
                              args.out, label_folder=args.label_folder,
                              with_labels=not args.no_masks,
                              with_cls=not args.no_cls, shards=args.shards)
    print(f"packed {n} samples ({args.dataset}/{args.split}) -> {args.out}"
          + (f" ({args.shards} shards)" if args.shards > 1 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
