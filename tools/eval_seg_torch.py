"""Offline segmentation evaluation CLI on the PyTorch port (dupl_tpu_torch).

    python tools/eval_seg_torch.py --weights w.npz --data-folder VOC2012 \
        --list-folder datasets/voc

Same flags as ``tools/eval_seg.py`` (reference: tools/eval_seg_voc.py,
tools/eval_seg_coco_ddp.py): multi-scale + flip inference, branch selection
by raw mIoU, CRF post-processing (device mean-field by default; ``--crf
native`` uses the C++ permutohedral oracle at native resolution).
``--weights`` takes the ``.npz`` written by either package's
``checkpoint.export_weights`` (or by ``tools/convert_ref_checkpoint_torch.py``
from a reference ``.pth``).  ``--dataset coco`` follows the reference's COCO
protocol: split ``val_part``, the fixed crop, scales 1.0 / 1.25 / 1.5 summed
at the scale-1.0 decoder grid.  ``--records`` reads a packed ``.duplrec``
shard (or a glob of shards) in place of the directory tree.  Plus
``--device`` (default ``cuda``): without a CUDA device the script refuses to
start unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def setup_logger() -> logging.Logger:
    logger = logging.getLogger("dupl_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(sh)
    return logger


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", choices=["voc", "coco"], default="voc")
    p.add_argument("--data-folder", default=None,
                   help="dataset directory tree")
    p.add_argument("--records", default=None,
                   help=".duplrec shard (or glob) of the eval split, in "
                        "place of --data-folder")
    p.add_argument("--list-folder", default=None)
    p.add_argument("--label-folder", default=None, help="COCO masks root")
    p.add_argument("--weights", default=None, help="weights .npz from training")
    p.add_argument("--infer-set", default=None, help="val / test / val_part")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--crf", choices=["device", "native", "none"], default="device")
    p.add_argument("--input-mode", choices=["fixed", "native"], default=None,
                   help="'native' evaluates at original image resolution "
                        "(reference VOC eval semantics). Default: native for "
                        "VOC, fixed for COCO, each reference script's own "
                        "protocol")
    p.add_argument("--transfer-dtype", default="uint8",
                   choices=["uint8", "float32"],
                   help="image wire format: uint8 ships raw pixels at 1/4 "
                        "the bytes and normalises on device (<=1 ulp from "
                        "the host path); float32 is the reference's format")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--scales", type=float, nargs="+", default=None)
    p.add_argument("--ensemble", action="store_true",
                   help="average both students' logits for the CRF pass "
                        "instead of picking the better branch")
    p.add_argument("--shard", type=int, default=0,
                   help="strided dataset shard (reference DDP eval split, "
                        "eval_seg_coco_ddp.py:240-242)")
    p.add_argument("--num-shards", type=int, default=1)
    p.add_argument("--branch", type=int, default=None, choices=[1, 2],
                   help="force the CRF branch (e.g. after a cross-shard "
                        "merged pick) instead of this run's local pick")
    p.add_argument("--save-hists", default=None,
                   help="save raw confusion matrices, and the branch the CRF "
                        "pass refined, to this .npz (for --merge-hists "
                        "across shards)")
    p.add_argument("--merge-hists", nargs="+", default=None,
                   help="merge per-shard hist .npz files into the global "
                        "protocol metric and exit (no inference)")
    p.add_argument("--backbone", default=None,
                   help="override backbone (e.g. test_tiny_patch16 for smoke)")
    p.add_argument("--crop-size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch paths")
    args = p.parse_args(argv)

    if args.merge_hists:
        return merge_main(args.merge_hists)
    if not args.weights:
        raise SystemExit("--weights is required (unless --merge-hists)")
    if not args.data_folder and not args.records:
        raise SystemExit("either --data-folder or --records is required")

    import dataclasses as dc

    from dupl_tpu_torch.config import coco_config, voc_config
    from dupl_tpu_torch.engine.eval_seg import SegEvaluator, resolve_input_mode
    from dupl_tpu_torch.models.convert import load_model
    from dupl_tpu_torch.utils.device import cli_device
    from dupl_tpu_torch.utils.metrics import format_score_table

    device = cli_device(args.device)
    log = setup_logger()
    args.input_mode = resolve_input_mode(args.dataset, args.input_mode, log)
    cfg = voc_config() if args.dataset == "voc" else coco_config()
    if args.backbone:
        cfg = dc.replace(cfg, model=dc.replace(cfg.model, backbone=args.backbone))
    if args.crop_size:
        cfg = dc.replace(cfg, data=dc.replace(cfg.data, crop_size=args.crop_size))
    list_folder = args.list_folder or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "datasets", args.dataset)

    ds = build_dataset(args, cfg, list_folder)
    if args.dataset == "voc":
        scales = tuple(args.scales or (1.0, 1.5, 1.25))
        merge, merge_at = "max", "input"          # eval_seg_voc.py:76-77
    else:
        scales = tuple(args.scales or (1.0, 1.25, 1.5))
        # summed at the scale-1.0 seg grid (eval_seg_coco_ddp.py:93-121)
        merge, merge_at = "sum", "decoder"

    ev = SegEvaluator(cfg, load_model(cfg, args.weights, device),
                      scales=scales, merge=merge, input_mode=args.input_mode,
                      merge_at="input" if args.input_mode == "native"
                      else merge_at)
    if args.num_shards > 1 and not (args.branch or args.ensemble):
        log.warning(
            "num_shards=%d: the branch pick below is LOCAL to this shard's "
            "stride; the reference protocol picks once from the merged "
            "histograms. Save each shard with --save-hists and combine with "
            "--merge-hists, which refuses CRF histograms of different "
            "branches: force --branch after a merged pick.",
            args.num_shards)
    res = ev.run(ds, batch_size=args.batch_size, crf=args.crf,
                 out_dir=args.out_dir, max_images=args.max_images, log=log,
                 shard=args.shard, num_shards=args.num_shards,
                 ensemble=args.ensemble, branch=args.branch)

    if args.save_hists:
        extra = ({"crf_hist": res["crf_hist"], "crf_branch": res["crf_branch"]}
                 if "crf_hist" in res else {})
        np.savez(args.save_hists, hist_1=res["hist_1"], hist_2=res["hist_2"],
                 **extra)
        log.info("histograms -> %s", args.save_hists)

    tables = [res["seg_score_1"], res["seg_score_2"]]
    names = ["Seg_1", "Seg_2"]
    if "crf_score" in res:
        tables.append(res["crf_score"])
        names.append("ensemble+CRF" if args.ensemble else f"branch{res['branch']}+CRF")
    print(format_score_table(tables, names, cfg.class_list))
    return res


def build_dataset(args, cfg, list_folder):
    """The evaluation split: VOC ``--infer-set`` (default ``val``; ``test``
    has no masks) or COCO ``--infer-set`` (default ``val_part``), from the
    directory tree or from ``--records``."""
    kw = dict(num_classes=cfg.num_classes, transfer_dtype=args.transfer_dtype)
    if args.dataset == "voc":
        split = args.infer_set or "val"
        stage = "test" if split == "test" else "val"
        if args.records:
            from dupl_tpu_torch.data.records import RecordVocSegDataset
            return RecordVocSegDataset(args.records, stage=stage, **kw)
        from dupl_tpu_torch.data.voc import VocSegDataset
        return VocSegDataset(args.data_folder, list_folder, split,
                             stage=stage, **kw)
    if args.records:
        from dupl_tpu_torch.data.records import RecordCocoSegDataset
        return RecordCocoSegDataset(args.records, **kw)
    from dupl_tpu_torch.data.coco import CocoSegDataset
    return CocoSegDataset(args.data_folder, list_folder,
                          args.infer_set or "val_part",
                          label_folder=args.label_folder, **kw)


def merge_main(paths):
    """--merge-hists: combine per-shard histogram files into the reference's
    single global metric (gather-then-pick, eval_seg_coco_ddp.py:244-254)."""
    from dupl_tpu_torch.config import coco_config, voc_config
    from dupl_tpu_torch.engine.eval_seg import merge_shard_results
    from dupl_tpu_torch.utils.metrics import format_score_table

    shards = [dict(np.load(p)) for p in paths]
    merged = merge_shard_results(shards)
    tables = [merged["seg_score_1"], merged["seg_score_2"]]
    names = ["Seg_1", "Seg_2"]
    if "crf_score" in merged:
        tables.append(merged["crf_score"])
        names.append("merged+CRF")
    nc = merged["hist_1"].shape[0]
    cfg = voc_config() if nc == 21 else coco_config()
    print(f"merged {len(shards)} shards -> branch {merged['branch']}")
    print(format_score_table(tables, names, cfg.class_list))
    return merged


if __name__ == "__main__":
    main()
